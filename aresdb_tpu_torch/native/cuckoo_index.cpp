// Cuckoo primary-key index with batch upsert classification.
//
// Native equivalent of the reference's C-memory CuckooIndex
// (memstore/cuckoo_index.go:66: 8-slot buckets, per-slot signature byte,
// 4 hash seeds, stash, random-walk eviction, optional eventTime lanes with
// lazy TTL expiry) plus the per-row classification loop of
// memstore/ingestion.go insertPrimaryKeys lifted to one native call per
// upsert batch — the Python layer only does vectorized column writes.
//
// Divergence from the reference layout: the GPU probe sharing this memory
// (query/hash_lookup.cu) has no TPU equivalent — joins probe a per-snapshot
// sorted key table instead — so the bucket memory layout here is free to be
// cache-friendly rather than device-sharable. Resize grows 2x (reference:
// 1.2x) since no device mirror constrains the allocation.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr int kBucketSize = 8;     // slots per bucket (reference HASH_BUCKET_SIZE)
constexpr int kNumHashes = 4;      // hash seeds (reference NumHashes)
constexpr int kStashSize = 4;      // overflow stash slots
constexpr int kMaxEvictions = 32;  // random-walk bound before resize

// murmur3 x86 32-bit (matching utils/hash.go Murmur3Sum32 semantics)
uint32_t murmur3_32(const uint8_t* key, int len, uint32_t seed) {
  const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
  uint32_t h = seed;
  const int nblocks = len / 4;
  for (int i = 0; i < nblocks; i++) {
    uint32_t k;
    std::memcpy(&k, key + i * 4, 4);
    k *= c1;
    k = (k << 15) | (k >> 17);
    k *= c2;
    h ^= k;
    h = (h << 13) | (h >> 19);
    h = h * 5 + 0xe6546b64u;
  }
  uint32_t k = 0;
  const uint8_t* tail = key + nblocks * 4;
  switch (len & 3) {
    case 3: k ^= static_cast<uint32_t>(tail[2]) << 16; [[fallthrough]];
    case 2: k ^= static_cast<uint32_t>(tail[1]) << 8; [[fallthrough]];
    case 1:
      k ^= tail[0];
      k *= c1;
      k = (k << 15) | (k >> 17);
      k *= c2;
      h ^= k;
  }
  h ^= static_cast<uint32_t>(len);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

struct RecordID {
  int32_t batch_id;
  uint32_t index;
};

struct Slot {
  uint8_t signature;  // 0 = empty (reference: signature forced >= 1)
  RecordID record;
  uint32_t event_time;
};

struct Bucket {
  Slot slots[kBucketSize];
};

// alignas(128): the partitioned primary key allocates two of these and
// probes them from two threads — without alignment the ~120-byte objects
// land on adjacent heap lines, so one partition's per-row size_ writes
// invalidate the line holding the other partition's buckets_/num_buckets_
// fields (read on EVERY probe), and the parallel classify runs slower
// than serial
class alignas(128) CuckooIndex {
  friend class PartitionedCuckoo;

 public:
  CuckooIndex(int key_bytes, bool has_event_time, int init_buckets)
      : key_bytes_(key_bytes), has_event_time_(has_event_time) {
    num_buckets_ = 16;
    while (num_buckets_ < init_buckets) num_buckets_ <<= 1;
    alloc_tables();
    seed_base_ = 0x9e3779b9u;
  }

  ~CuckooIndex() {
    std::free(buckets_);
    std::free(keys_);
    std::free(stash_keys_);
  }

  int64_t size() const { return size_; }

  int64_t allocated_bytes() const {
    return static_cast<int64_t>(num_buckets_) *
               (sizeof(Bucket) + kBucketSize * key_bytes_) +
           kStashSize * (sizeof(Slot) + key_bytes_);
  }

  void set_cutoff(uint32_t cutoff) { cutoff_ = cutoff; }

  // one-shot growth ahead of chunked classification (see presize_for)
  void reserve(int64_t extra) { presize_for(extra); }

  bool find(const uint8_t* key, RecordID* out) {
    Slot* s = lookup(key);
    if (s == nullptr) return false;
    if (expired(*s)) {
      s->signature = 0;
      size_--;
      return false;
    }
    *out = s->record;
    return true;
  }

  // returns 1 if existing (out = stored record), 0 if inserted (out = rec)
  int find_or_insert(const uint8_t* key, RecordID rec, uint32_t event_time,
                     RecordID* out) {
    // reference cuckoo_index.go: inserting with an event time already
    // below the TTL cutoff is an error (the row belongs to backfill)
    if (has_event_time_ && cutoff_ != 0 && event_time < cutoff_) {
      return -1;
    }
    Slot* s = lookup(key);
    if (s != nullptr) {
      if (!expired(*s)) {
        *out = s->record;
        return 1;
      }
      // expired: reuse the slot in place
      s->record = rec;
      s->event_time = event_time;
      *out = rec;
      return 0;
    }
    insert(key, rec, event_time);
    *out = rec;
    return 0;
  }

  bool update(const uint8_t* key, RecordID rec) {
    Slot* s = lookup(key);
    if (s == nullptr || expired(*s)) return false;
    s->record = rec;
    return true;
  }

  void erase(const uint8_t* key) {
    Slot* s = lookup(key);
    if (s != nullptr) {
      s->signature = 0;
      size_--;
    }
  }

  // Batch classification: the whole insertPrimaryKeys row loop in one call.
  // actions: 0 skip-null-pk, 1 insert, 2 update, 3 backfill, 4 retention.
  // For insert rows, destination records are allocated sequentially from
  // (next_batch, next_index) spilling at batch_capacity. Duplicate keys in
  // the same batch become updates of the pending insert's record.
  void classify(const uint8_t* keys, int n, const uint8_t* key_valid,
                const int64_t* event_times, int64_t cutoff,
                int64_t retention_ts, int64_t future_ts, int32_t next_batch,
                uint32_t next_index, uint32_t batch_capacity, uint8_t* actions,
                int32_t* out_batch, uint32_t* out_index, int32_t* out_counts) {
    int32_t inserted = 0, updated = 0, backfilled = 0, retention = 0,
            nullpk = 0, future = 0;
    // pre-size for the incoming batch: one rehash up front instead of
    // eviction storms at high load + mid-batch doubling rehashes
    uint64_t need = static_cast<uint64_t>(size_) + static_cast<uint64_t>(n);
    uint64_t nb = num_buckets_;
    while (need * 20 > nb * kBucketSize * 17) nb <<= 1;
    grow_to(nb);
    // software-prefetch the probe buckets a window ahead: the loop is
    // DRAM-latency bound (4 random cachelines per probe)
    constexpr int kWindow = 16;
    auto prefetch_row = [&](int j) {
      if (j >= n || !key_valid[j]) return;
      const uint8_t* k = keys + static_cast<int64_t>(j) * key_bytes_;
      // h0 only: most lookups hit the first hash position, and 4-way
      // prefetch costs more hash compute + bandwidth than it hides
      uint64_t b = murmur3_32(k, key_bytes_, seed_base_) &
                   (num_buckets_ - 1);
      __builtin_prefetch(&buckets_[b], 0, 1);
      __builtin_prefetch(bucket_key(b, 0), 0, 1);
    };
    for (int j = 0; j < kWindow; j++) prefetch_row(j);
    for (int i = 0; i < n; i++) {
      prefetch_row(i + kWindow);
      const uint8_t* key = keys + static_cast<int64_t>(i) * key_bytes_;
      if (!key_valid[i]) {
        actions[i] = 0;
        nullpk++;
        continue;
      }
      int64_t et = event_times ? event_times[i] : 0;
      if (retention_ts > 0 && et < retention_ts) {
        actions[i] = 4;
        retention++;
        continue;
      }
      // reference ingestion.go:254 — skip records from the future
      if (future_ts > 0 && et > future_ts) {
        actions[i] = 5;
        future++;
        continue;
      }
      // single probe per row: ONE fused walk yields both the match and
      // the first insertable slot, so neither find()+find_or_insert()
      // nor lookup()+insert() repeat the 4-position probe
      Probe pr = probe_for_classify(key);
      Slot* slot = pr.match;
      if (slot != nullptr && expired(*slot)) {
        slot->signature = 0;
        size_--;
        slot = nullptr;
      }
      if (slot != nullptr) {
        actions[i] = 2;
        out_batch[i] = slot->record.batch_id;
        out_index[i] = slot->record.index;
        updated++;
        continue;
      }
      if (cutoff > 0 && et < cutoff) {
        actions[i] = 3;
        backfilled++;
        continue;
      }
      if (next_index >= batch_capacity) {
        next_batch++;
        next_index = 0;
      }
      RecordID rec{next_batch, next_index};
      next_index++;
      if (pr.empty_s >= 0) {
        // direct write into the slot the probe already found
        Slot& dst = buckets_[pr.empty_b].slots[pr.empty_s];
        if (pr.empty_expired) size_--;  // replacing an expired entry
        dst.signature = pr.empty_sig;
        dst.record = rec;
        dst.event_time = static_cast<uint32_t>(et);
        std::memcpy(bucket_key(pr.empty_b, pr.empty_s), key, key_bytes_);
        size_++;
      } else {
        insert(key, rec, static_cast<uint32_t>(et));
      }
      actions[i] = 1;
      out_batch[i] = rec.batch_id;
      out_index[i] = rec.index;
      inserted++;
    }
    out_counts[0] = inserted;
    out_counts[1] = updated;
    out_counts[2] = backfilled;
    out_counts[3] = retention;
    out_counts[4] = nullpk;
    out_counts[5] = next_batch;
    out_counts[6] = static_cast<int32_t>(next_index);
    out_counts[7] = future;
  }

  // iterate all live entries: fills keys/records up to cap, returns count
  int64_t dump(uint8_t* keys_out, int32_t* batch_out, uint32_t* index_out,
               int64_t cap) {
    int64_t k = 0;
    for (uint64_t b = 0; b < num_buckets_ && k < cap; b++) {
      for (int s = 0; s < kBucketSize && k < cap; s++) {
        Slot& slot = buckets_[b].slots[s];
        if (slot.signature != 0 && !expired(slot)) {
          std::memcpy(keys_out + k * key_bytes_, bucket_key(b, s), key_bytes_);
          batch_out[k] = slot.record.batch_id;
          index_out[k] = slot.record.index;
          k++;
        }
      }
    }
    for (int s = 0; s < kStashSize && k < cap; s++) {
      if (stash_[s].signature != 0 && !expired(stash_[s])) {
        std::memcpy(keys_out + k * key_bytes_, stash_keys_ + s * key_bytes_,
                    key_bytes_);
        batch_out[k] = stash_[s].record.batch_id;
        index_out[k] = stash_[s].record.index;
        k++;
      }
    }
    return k;
  }

 private:
  void alloc_tables() {
    buckets_ = static_cast<Bucket*>(
        std::calloc(num_buckets_, sizeof(Bucket)));
    keys_ = static_cast<uint8_t*>(
        std::calloc(num_buckets_ * kBucketSize, key_bytes_));
    stash_keys_ = static_cast<uint8_t*>(std::calloc(kStashSize, key_bytes_));
    std::memset(stash_, 0, sizeof(stash_));
    if (!buckets_ || !keys_ || !stash_keys_) throw std::bad_alloc();
  }

  uint8_t* bucket_key(uint64_t bucket, int slot) {
    return keys_ + (bucket * kBucketSize + slot) * key_bytes_;
  }

  bool expired(const Slot& s) const {
    // reference parity (memstore/cuckoo_index.go:337 eventTimeExpired):
    // cutoff > eventTime, with NO zero special-case — a fact row stamped
    // at epoch 0 must expire like any other once the cutoff advances
    return has_event_time_ && cutoff_ != 0 && s.event_time < cutoff_;
  }

  uint8_t signature_of(uint32_t hash) const {
    uint8_t sig = static_cast<uint8_t>(hash >> 24);
    return sig < 1 ? 1 : sig;  // reference: signature forced >= 1
  }

  Slot* lookup(const uint8_t* key) {
    for (int h = 0; h < kNumHashes; h++) {
      uint32_t hash = murmur3_32(key, key_bytes_, seed_base_ + h);
      uint64_t b = hash & (num_buckets_ - 1);
      uint8_t sig = signature_of(hash);
      for (int s = 0; s < kBucketSize; s++) {
        Slot& slot = buckets_[b].slots[s];
        if (slot.signature == sig &&
            std::memcmp(bucket_key(b, s), key, key_bytes_) == 0) {
          return &slot;
        }
      }
    }
    for (int s = 0; s < kStashSize; s++) {
      if (stash_[s].signature != 0 &&
          std::memcmp(stash_keys_ + s * key_bytes_, key, key_bytes_) == 0) {
        return &stash_[s];
      }
    }
    return nullptr;
  }

  // ---- partitioned-classification support (round 5) ----

  // location encoding: bucket*kBucketSize+slot, or kStashLocBase+s for
  // stash slots (stash locations only arise via the provisional-insert
  // tracking hook; bucket locations stay valid across growth because the
  // rehash hook rewrites every provisional entry's location)
  static constexpr uint64_t kStashLocBase = ~uint64_t(0) - kStashSize;

  Slot* slot_at(uint64_t loc) {
    if (loc >= kStashLocBase)
      return &stash_[loc - kStashLocBase];
    return &buckets_[loc / kBucketSize].slots[loc % kBucketSize];
  }

  void presize_for(int64_t extra) {
    uint64_t need = static_cast<uint64_t>(size_) +
                    static_cast<uint64_t>(extra);
    uint64_t nb = num_buckets_;
    while (need * 20 > nb * kBucketSize * 17) nb <<= 1;
    grow_to(nb);
  }

  // Phase-1 body for one partition over its routed row subset. Runs on
  // its own thread but touches ONLY this partition's memory: every row
  // resolves inline and in row order (duplicate keys always route to the
  // same partition), so the classification semantics are exactly serial.
  // Fresh keys direct-write a PROVISIONAL record {prov_tag, rank} into
  // the fused probe's first empty slot; when a key's 4x8 candidate slots
  // are all occupied, the standard eviction insert runs instead, with
  // prov_locs_ tracking active so displaced/rehashed provisional entries
  // keep their recorded locations valid for the caller's patch phase.
  //
  // Outputs are COMPACT (indexed by j, the position in this partition's
  // row list), not row-indexed: two threads writing a shared row-indexed
  // array at interleaved positions false-share every output cacheline
  // (routing is pseudo-random, so adjacent rows belong to different
  // partitions). The serial phase-2 walk scatters them back while it
  // allocates record ids.
  void classify_part(const uint8_t* keys, const int32_t* rows, int m,
                     const int64_t* event_times, int64_t cutoff,
                     int32_t prov_tag, uint8_t* actions_c,
                     int32_t* out_batch_c, uint32_t* out_index_c,
                     uint64_t* locations_out, int32_t* n_inserts_out,
                     int32_t* updated_out, int32_t* backfilled_out) {
    int32_t rank = 0, updated = 0, backfilled = 0;
    prov_tag_ = prov_tag;
    prov_locs_ = locations_out;
    constexpr int kWindow = 16;
    auto prefetch_row = [&](int j) {
      if (j >= m) return;
      const uint8_t* k =
          keys + static_cast<int64_t>(rows[j]) * key_bytes_;
      uint64_t b = murmur3_32(k, key_bytes_, seed_base_) &
                   (num_buckets_ - 1);
      __builtin_prefetch(&buckets_[b], 0, 1);
      __builtin_prefetch(bucket_key(b, 0), 0, 1);
    };
    for (int j = 0; j < kWindow; j++) prefetch_row(j);
    for (int j = 0; j < m; j++) {
      prefetch_row(j + kWindow);
      int i = rows[j];
      const uint8_t* key = keys + static_cast<int64_t>(i) * key_bytes_;
      int64_t et = event_times ? event_times[i] : 0;
      Probe pr = probe_for_classify(key);
      Slot* slot = pr.match;
      if (slot != nullptr && expired(*slot)) {
        slot->signature = 0;
        size_--;
        slot = nullptr;
      }
      if (slot != nullptr) {
        actions_c[j] = 2;
        out_batch_c[j] = slot->record.batch_id;
        out_index_c[j] = slot->record.index;
        updated++;
        continue;
      }
      if (cutoff > 0 && et < cutoff) {
        actions_c[j] = 3;
        backfilled++;
        continue;
      }
      if (pr.empty_s >= 0) {
        Slot& dst = buckets_[pr.empty_b].slots[pr.empty_s];
        if (pr.empty_expired) size_--;
        dst.signature = pr.empty_sig;
        dst.record = RecordID{prov_tag, static_cast<uint32_t>(rank)};
        dst.event_time = static_cast<uint32_t>(et);
        std::memcpy(bucket_key(pr.empty_b, pr.empty_s), key, key_bytes_);
        size_++;
        locations_out[rank] =
            pr.empty_b * static_cast<uint64_t>(kBucketSize) + pr.empty_s;
      } else {
        // all 32 candidate slots occupied (rare at <=68% load): run the
        // standard eviction insert; the prov_locs_ hook keeps every
        // displaced provisional entry's location current
        insert(key, RecordID{prov_tag, static_cast<uint32_t>(rank)},
               static_cast<uint32_t>(et));
      }
      actions_c[j] = 1;
      out_batch_c[j] = prov_tag;
      out_index_c[j] = static_cast<uint32_t>(rank);
      rank++;
    }
    prov_tag_ = 0;
    prov_locs_ = nullptr;
    *n_inserts_out = rank;
    *updated_out = updated;
    *backfilled_out = backfilled;
  }

  // Fused lookup + first-empty discovery for the classify loop: ONE walk
  // over the kNumHashes positions yields the match (if any) AND the first
  // insertable slot (empty or expired), so a fresh key's insert skips the
  // insert() path's second identical probe — the dominant cost of
  // insert-heavy batch classification (each probe is ~4 random
  // cachelines).
  struct Probe {
    Slot* match = nullptr;
    uint64_t empty_b = 0;
    int empty_s = -1;
    uint8_t empty_sig = 0;
    bool empty_expired = false;
  };

  Probe probe_for_classify(const uint8_t* key) {
    Probe r;
    for (int h = 0; h < kNumHashes; h++) {
      uint32_t hash = murmur3_32(key, key_bytes_, seed_base_ + h);
      uint64_t b = hash & (num_buckets_ - 1);
      uint8_t sig = signature_of(hash);
      // match scan first (tight — the UPDATE hot path exits here with no
      // empty-tracking overhead), then a cache-hot second pass over the
      // same bucket records the first insertable slot for the miss path
      for (int s = 0; s < kBucketSize; s++) {
        Slot& slot = buckets_[b].slots[s];
        if (slot.signature == sig &&
            std::memcmp(bucket_key(b, s), key, key_bytes_) == 0) {
          r.match = &slot;
          return r;
        }
      }
      if (r.empty_s < 0) {
        for (int s = 0; s < kBucketSize; s++) {
          Slot& slot = buckets_[b].slots[s];
          if (slot.signature == 0 || expired(slot)) {
            r.empty_b = b;
            r.empty_s = s;
            r.empty_sig = sig;
            r.empty_expired = slot.signature != 0;
            break;
          }
        }
      }
    }
    for (int s = 0; s < kStashSize; s++) {
      if (stash_[s].signature != 0 &&
          std::memcmp(stash_keys_ + s * key_bytes_, key, key_bytes_) == 0) {
        r.match = &stash_[s];
        return r;
      }
    }
    return r;
  }

  // location-tracking hook for the partitioned classify: while a
  // classify_part call is active (prov_tag_ != 0), every placement of a
  // slot holding a provisional record {prov_tag_, rank} refreshes
  // prov_locs_[rank], so eviction chains / stash spills / growth rehashes
  // never invalidate the caller's recorded locations
  void track_prov(const RecordID& rec, uint64_t loc) {
    if (prov_tag_ != 0 && rec.batch_id == prov_tag_)
      prov_locs_[rec.index] = loc;
  }

  void insert(const uint8_t* key, RecordID rec, uint32_t event_time) {
    uint8_t cur_key[256];
    std::memcpy(cur_key, key, key_bytes_);
    Slot cur{0, rec, event_time};
    uint32_t h0 = murmur3_32(cur_key, key_bytes_, seed_base_);
    cur.signature = signature_of(h0);

    for (int evict = 0; evict < kMaxEvictions; evict++) {
      // try all hash positions for an empty (or expired) slot
      for (int h = 0; h < kNumHashes; h++) {
        uint32_t hash = murmur3_32(cur_key, key_bytes_, seed_base_ + h);
        uint64_t b = hash & (num_buckets_ - 1);
        uint8_t sig = signature_of(hash);
        for (int s = 0; s < kBucketSize; s++) {
          Slot& slot = buckets_[b].slots[s];
          if (slot.signature == 0 || expired(slot)) {
            if (slot.signature != 0) size_--;  // replacing expired
            slot = cur;
            slot.signature = sig;
            std::memcpy(bucket_key(b, s), cur_key, key_bytes_);
            size_++;
            track_prov(slot.record, b * kBucketSize + s);
            return;
          }
        }
      }
      // random-walk eviction: displace a pseudo-random slot of hash-0 bucket
      uint32_t hash = murmur3_32(cur_key, key_bytes_, seed_base_);
      uint64_t b = hash & (num_buckets_ - 1);
      int victim = (rng_state_ = rng_state_ * 1103515245u + 12345u) %
                   kBucketSize;
      Slot tmp = buckets_[b].slots[victim];
      uint8_t tmp_key[256];
      std::memcpy(tmp_key, bucket_key(b, victim), key_bytes_);
      buckets_[b].slots[victim] = cur;
      buckets_[b].slots[victim].signature = signature_of(hash);
      std::memcpy(bucket_key(b, victim), cur_key, key_bytes_);
      track_prov(cur.record, b * kBucketSize + victim);
      cur = tmp;
      std::memcpy(cur_key, tmp_key, key_bytes_);
    }
    // stash, else resize
    for (int s = 0; s < kStashSize; s++) {
      if (stash_[s].signature == 0 || expired(stash_[s])) {
        if (stash_[s].signature != 0) size_--;
        stash_[s] = cur;
        if (stash_[s].signature == 0) stash_[s].signature = 1;
        std::memcpy(stash_keys_ + s * key_bytes_, cur_key, key_bytes_);
        size_++;
        track_prov(stash_[s].record, kStashLocBase + s);
        return;
      }
    }
    resize();
    insert(cur_key, cur.record, cur.event_time);
  }

  void resize() { grow_to(num_buckets_ << 1); }

  // Rehash into new_buckets (>= current). Proactive growth keeps the load
  // factor below ~70%: at stash-overflow load (95%+) every insert does long
  // random-walk evictions and batch ingestion turns quadratic.
  void grow_to(uint64_t new_buckets) {
    if (new_buckets <= num_buckets_) return;
    uint64_t old_buckets = num_buckets_;
    Bucket* ob = buckets_;
    uint8_t* ok = keys_;
    Slot old_stash[kStashSize];
    std::memcpy(old_stash, stash_, sizeof(stash_));
    uint8_t* osk = stash_keys_;

    num_buckets_ = new_buckets;
    size_ = 0;
    alloc_tables();

    for (uint64_t b = 0; b < old_buckets; b++) {
      for (int s = 0; s < kBucketSize; s++) {
        Slot& slot = ob[b].slots[s];
        if (slot.signature != 0 && !expired(slot)) {
          insert(ok + (b * kBucketSize + s) * key_bytes_, slot.record,
                 slot.event_time);
        }
      }
    }
    for (int s = 0; s < kStashSize; s++) {
      if (old_stash[s].signature != 0 && !expired(old_stash[s])) {
        insert(osk + s * key_bytes_, old_stash[s].record,
               old_stash[s].event_time);
      }
    }
    std::free(ob);
    std::free(ok);
    std::free(osk);
  }

  int key_bytes_;
  bool has_event_time_;
  uint64_t num_buckets_ = 0;
  Bucket* buckets_ = nullptr;
  uint8_t* keys_ = nullptr;
  Slot stash_[kStashSize];
  uint8_t* stash_keys_ = nullptr;
  int64_t size_ = 0;
  uint32_t cutoff_ = 0;
  uint32_t seed_base_;
  uint32_t rng_state_ = 0x12345678u;
  // active only inside classify_part (see track_prov)
  int32_t prov_tag_ = 0;
  uint64_t* prov_locs_ = nullptr;
};

// Hash-partitioned primary key: each key routes by independent murmur
// bits to one of `parts` CuckooIndex sub-tables so batch classification
// (the serial wall of ingestion — reference memstore/ingestion.go:172
// insertPrimaryKeys) runs the probe/insert loop on `parts` cores. The
// reference keeps one table per shard and relies on inter-shard
// parallelism; a single-shard TPU node has spare host cores instead, so
// the table itself is split. parts must be a power of two in [2, 8]
// (2 is the measured optimum on a 4-core host; 4/8 target bigger hosts).
//
// Classification runs in three phases so the result is BYTE-IDENTICAL to
// the serial path (same actions, same record ids, same counts):
//   0. serial router: null/retention/future checks + per-partition row
//      lists (dup keys always land in the same partition, so each
//      partition thread sees its duplicates in row order).
//   1. parallel, per partition: probe; updates/backfills resolve
//      directly; fresh keys write a PROVISIONAL record {prov_tag, rank}
//      — direct into the probe's first empty slot, or through the
//      standard eviction insert when all 4x8 candidates are occupied
//      (the track_prov hook keeps recorded locations valid across
//      eviction chains / stash spills / rehashes). Outputs are compact
//      per-partition arrays: row-indexed shared outputs false-share
//      nearly every cacheline between the threads.
//   2. serial: walk rows in original order, scatter the compact outputs
//      back, allocate real record ids in arrival order (exactly the
//      serial spill logic), and patch the provisional slots through
//      their recorded locations (including same-batch dup updates that
//      captured a provisional id).
class PartitionedCuckoo {
 public:
  static constexpr int kMaxParts = 16;
  // provisional batch ids INT32_MAX-p: live batches are negative
  // (memstore), so these can never collide with a real record
  static constexpr int32_t kProvBase = INT32_MAX;

  PartitionedCuckoo(int key_bytes, bool has_event_time, int init_buckets,
                    int parts)
      : key_bytes_(key_bytes), parts_n_(parts) {
    for (int p = 0; p < parts_n_; p++)
      parts_[p] = new CuckooIndex(key_bytes, has_event_time, init_buckets);
  }
  ~PartitionedCuckoo() {
    for (int p = 0; p < parts_n_; p++) delete parts_[p];
  }

  int64_t size() const {
    int64_t s = 0;
    for (int p = 0; p < parts_n_; p++) s += parts_[p]->size();
    return s;
  }
  int64_t allocated_bytes() const {
    int64_t s = 0;
    for (int p = 0; p < parts_n_; p++) s += parts_[p]->allocated_bytes();
    return s;
  }
  void set_cutoff(uint32_t cutoff) {
    for (int p = 0; p < parts_n_; p++) parts_[p]->set_cutoff(cutoff);
  }

  int part_of(const uint8_t* key) const {
    // seed independent of the bucket/signature seeds (0x9e3779b9+h)
    return murmur3_32(key, key_bytes_, 0x51ed270bu) & (parts_n_ - 1);
  }

  // Pre-size every partition for `extra` incoming keys in ONE growth:
  // chunked classification otherwise re-doubles each table several times
  // mid-batch, re-inserting ~2x every key (measured 3.1 vs 5.7 M keys/s
  // at 512k chunks over 16M rows). Routing is near-uniform, so each
  // partition expects extra/parts keys (+1.5% slack for binomial spread).
  void reserve(int64_t extra) {
    int64_t per = extra / parts_n_;
    per += per / 64 + 16;
    for (int p = 0; p < parts_n_; p++) parts_[p]->presize_for(per);
  }

  bool find(const uint8_t* key, RecordID* out) {
    return parts_[part_of(key)]->find(key, out);
  }
  int find_or_insert(const uint8_t* key, RecordID rec, uint32_t event_time,
                     RecordID* out) {
    return parts_[part_of(key)]->find_or_insert(key, rec, event_time, out);
  }
  bool update(const uint8_t* key, RecordID rec) {
    return parts_[part_of(key)]->update(key, rec);
  }
  void erase(const uint8_t* key) { parts_[part_of(key)]->erase(key); }

  int64_t dump(uint8_t* keys_out, int32_t* batch_out, uint32_t* index_out,
               int64_t cap) {
    int64_t k = 0;
    for (int p = 0; p < parts_n_; p++)
      k += parts_[p]->dump(keys_out + k * key_bytes_, batch_out + k,
                           index_out + k, cap - k);
    return k;
  }

  void classify(const uint8_t* keys, int n, const uint8_t* key_valid,
                const int64_t* event_times, int64_t cutoff,
                int64_t retention_ts, int64_t future_ts, int32_t next_batch,
                uint32_t next_index, uint32_t batch_capacity,
                uint8_t* actions, int32_t* out_batch, uint32_t* out_index,
                int32_t* out_counts) {
    static const bool debug_timing = std::getenv("ARES_PK_DEBUG") != nullptr;
    auto now_s = [] {
      struct timespec ts;
      clock_gettime(CLOCK_MONOTONIC, &ts);
      return ts.tv_sec + ts.tv_nsec * 1e-9;
    };
    double t0 = debug_timing ? now_s() : 0.0;
    const int P = parts_n_;
    int32_t retention = 0, nullpk = 0, future = 0;
    std::vector<int32_t> rows[kMaxParts];
    // row -> partition map (255 = router-skipped); read serially in
    // phase 2, never touched by the phase-1 workers
    std::vector<uint8_t> row_part(n);
    for (int p = 0; p < P; p++) rows[p].reserve(n / P + 16);
    // phase 0a (parallel over contiguous row ranges — every write is to a
    // thread-private range of row_part/actions): pre-checks + the routing
    // murmur, the expensive part of the router
    const int RT = (n >= (1 << 16)) ? 4 : 1;
    int32_t pre_counts[4][3] = {};
    {
      auto route_range = [&](int t) {
        int64_t chunk = (n + RT - 1) / RT;
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        int32_t np = 0, rt_ = 0, fu = 0;
        for (int64_t i = lo; i < hi; i++) {
          if (!key_valid[i]) {
            actions[i] = 0;
            row_part[i] = 255;
            np++;
            continue;
          }
          int64_t et = event_times ? event_times[i] : 0;
          if (retention_ts > 0 && et < retention_ts) {
            actions[i] = 4;
            row_part[i] = 255;
            rt_++;
            continue;
          }
          if (future_ts > 0 && et > future_ts) {
            actions[i] = 5;
            row_part[i] = 255;
            fu++;
            continue;
          }
          const uint8_t* key = keys + i * key_bytes_;
          row_part[i] = static_cast<uint8_t>(part_of(key));
        }
        pre_counts[t][0] = np;
        pre_counts[t][1] = rt_;
        pre_counts[t][2] = fu;
      };
      std::vector<std::thread> rts;
      for (int t = 1; t < RT; t++) rts.emplace_back(route_range, t);
      route_range(0);
      for (auto& t : rts) t.join();
      for (int t = 0; t < RT; t++) {
        nullpk += pre_counts[t][0];
        retention += pre_counts[t][1];
        future += pre_counts[t][2];
      }
    }
    // phase 0b (serial): build the per-partition row lists
    for (int i = 0; i < n; i++) {
      if (row_part[i] != 255) rows[row_part[i]].push_back(i);
    }
    double t_route = debug_timing ? now_s() : 0.0;
    for (int p = 0; p < P; p++)
      parts_[p]->presize_for(static_cast<int64_t>(rows[p].size()));
    double t_presize = debug_timing ? now_s() : 0.0;

    // phase 1: parallel per-partition probe/provisional-insert into
    // per-partition COMPACT output arrays (no shared-cacheline writes)
    std::vector<uint64_t> locs[kMaxParts];
    std::vector<uint8_t> act_c[kMaxParts];
    std::vector<int32_t> db_c[kMaxParts];
    std::vector<uint32_t> di_c[kMaxParts];
    int32_t n_ins[kMaxParts] = {0};
    int32_t upd[kMaxParts] = {0}, bfill[kMaxParts] = {0};
    auto run_part = [&](int p) {
      size_t m = rows[p].size();
      locs[p].resize(m);
      act_c[p].resize(m);
      db_c[p].resize(m);
      di_c[p].resize(m);
      parts_[p]->classify_part(
          keys, rows[p].data(), static_cast<int>(m), event_times, cutoff,
          kProvBase - p, act_c[p].data(), db_c[p].data(), di_c[p].data(),
          locs[p].data(), &n_ins[p], &upd[p], &bfill[p]);
    };
    std::vector<std::thread> workers;
    for (int p = 1; p < P; p++)
      if (!rows[p].empty()) workers.emplace_back(run_part, p);
    run_part(0);
    for (auto& t : workers) t.join();
    double t_phase1 = debug_timing ? now_s() : 0.0;

    // phase 2a: ONE serial walk over the rows in original order scatters
    // the compact outputs back AND allocates record ids in arrival order
    // (exactly the serial spill logic); slot patches are deferred to a
    // parallel per-partition pass (2b) — they are random DRAM writes into
    // each partition's own table, the expensive part of this phase
    std::vector<RecordID> fin[kMaxParts];
    for (int p = 0; p < P; p++) fin[p].resize(n_ins[p]);
    int32_t inserted = 0;
    size_t cur[kMaxParts] = {0};
    for (int i = 0; i < n; i++) {
      int p = row_part[i];
      if (p == 255) continue;  // router-skipped row; action already set
      size_t j = cur[p]++;
      uint8_t a = act_c[p][j];
      actions[i] = a;
      if (a == 1) {
        uint32_t r = di_c[p][j];
        if (next_index >= batch_capacity) {
          next_batch++;
          next_index = 0;
        }
        RecordID rec{next_batch, next_index};
        next_index++;
        fin[p][r] = rec;
        out_batch[i] = rec.batch_id;
        out_index[i] = rec.index;
        inserted++;
      } else if (a == 2 && db_c[p][j] == kProvBase - p) {
        // same-batch dup update captured a provisional id; the insert row
        // always precedes it, so its final id is already assigned
        RecordID rec = fin[p][di_c[p][j]];
        out_batch[i] = rec.batch_id;
        out_index[i] = rec.index;
      } else if (a == 2) {
        out_batch[i] = db_c[p][j];
        out_index[i] = di_c[p][j];
      }
    }
    // phase 2b (parallel): patch the provisional slots with their final
    // records — partition-private random writes
    {
      auto patch = [&](int p) {
        for (int32_t r = 0; r < n_ins[p]; r++)
          parts_[p]->slot_at(locs[p][r])->record = fin[p][r];
      };
      std::vector<std::thread> pts;
      for (int p = 1; p < P; p++)
        if (n_ins[p] > 0) pts.emplace_back(patch, p);
      patch(0);
      for (auto& t : pts) t.join();
    }
    out_counts[0] = inserted;
    out_counts[1] = 0;
    out_counts[2] = 0;
    for (int p = 0; p < P; p++) {
      out_counts[1] += upd[p];
      out_counts[2] += bfill[p];
    }
    out_counts[3] = retention;
    out_counts[4] = nullpk;
    out_counts[5] = next_batch;
    out_counts[6] = static_cast<int32_t>(next_index);
    out_counts[7] = future;
    if (debug_timing) {
      double t_end = now_s();
      std::fprintf(stderr,
                   "pk%d n=%d route=%.3f presize=%.3f phase1=%.3f "
                   "phase2=%.3f\n",
                   P, n, t_route - t0, t_presize - t_route,
                   t_phase1 - t_presize, t_end - t_phase1);
    }
  }

 private:
  int key_bytes_;
  int parts_n_;
  CuckooIndex* parts_[kMaxParts];
};

}  // namespace

extern "C" {

void* cuckoo_new(int key_bytes, int has_event_time, int init_buckets) {
  if (key_bytes <= 0 || key_bytes > 256) return nullptr;
  try {
    return new CuckooIndex(key_bytes, has_event_time != 0, init_buckets);
  } catch (...) {
    return nullptr;
  }
}

void cuckoo_free(void* h) { delete static_cast<CuckooIndex*>(h); }

int64_t cuckoo_size(void* h) { return static_cast<CuckooIndex*>(h)->size(); }

int64_t cuckoo_bytes(void* h) {
  return static_cast<CuckooIndex*>(h)->allocated_bytes();
}

void cuckoo_set_cutoff(void* h, uint32_t cutoff) {
  static_cast<CuckooIndex*>(h)->set_cutoff(cutoff);
}

int cuckoo_find(void* h, const uint8_t* key, int32_t* batch, uint32_t* index) {
  RecordID rec;
  if (!static_cast<CuckooIndex*>(h)->find(key, &rec)) return 0;
  *batch = rec.batch_id;
  *index = rec.index;
  return 1;
}

int cuckoo_find_or_insert(void* h, const uint8_t* key, int32_t batch,
                          uint32_t index, uint32_t event_time,
                          int32_t* out_batch, uint32_t* out_index) {
  RecordID out;
  int existing = static_cast<CuckooIndex*>(h)->find_or_insert(
      key, RecordID{batch, index}, event_time, &out);
  *out_batch = out.batch_id;
  *out_index = out.index;
  return existing;
}

int cuckoo_update(void* h, const uint8_t* key, int32_t batch, uint32_t index) {
  return static_cast<CuckooIndex*>(h)->update(key, RecordID{batch, index})
             ? 1
             : 0;
}

void cuckoo_delete(void* h, const uint8_t* key) {
  static_cast<CuckooIndex*>(h)->erase(key);
}

void cuckoo_classify(void* h, const uint8_t* keys, int n,
                     const uint8_t* key_valid, const int64_t* event_times,
                     int64_t cutoff, int64_t retention_ts, int64_t future_ts,
                     int32_t next_batch, uint32_t next_index,
                     uint32_t batch_capacity, uint8_t* actions,
                     int32_t* out_batch, uint32_t* out_index,
                     int32_t* out_counts) {
  static_cast<CuckooIndex*>(h)->classify(
      keys, n, key_valid, event_times, cutoff, retention_ts, future_ts,
      next_batch, next_index, batch_capacity, actions, out_batch, out_index,
      out_counts);
}

int64_t cuckoo_dump(void* h, uint8_t* keys_out, int32_t* batch_out,
                    uint32_t* index_out, int64_t cap) {
  return static_cast<CuckooIndex*>(h)->dump(keys_out, batch_out, index_out,
                                            cap);
}

// ---- partitioned primary key (same surface, pk2_ prefix) ----

void* pk2_new(int key_bytes, int has_event_time, int init_buckets,
              int parts) {
  if (key_bytes <= 0 || key_bytes > 256) return nullptr;
  if (parts != 2 && parts != 4 && parts != 8 && parts != 16) return nullptr;
  try {
    return new PartitionedCuckoo(key_bytes, has_event_time != 0,
                                 init_buckets, parts);
  } catch (...) {
    return nullptr;
  }
}

void pk2_free(void* h) { delete static_cast<PartitionedCuckoo*>(h); }

int64_t pk2_size(void* h) {
  return static_cast<PartitionedCuckoo*>(h)->size();
}

int64_t pk2_bytes(void* h) {
  return static_cast<PartitionedCuckoo*>(h)->allocated_bytes();
}

void pk2_set_cutoff(void* h, uint32_t cutoff) {
  static_cast<PartitionedCuckoo*>(h)->set_cutoff(cutoff);
}

int pk2_find(void* h, const uint8_t* key, int32_t* batch, uint32_t* index) {
  RecordID rec;
  if (!static_cast<PartitionedCuckoo*>(h)->find(key, &rec)) return 0;
  *batch = rec.batch_id;
  *index = rec.index;
  return 1;
}

int pk2_find_or_insert(void* h, const uint8_t* key, int32_t batch,
                       uint32_t index, uint32_t event_time,
                       int32_t* out_batch, uint32_t* out_index) {
  RecordID out;
  int existing = static_cast<PartitionedCuckoo*>(h)->find_or_insert(
      key, RecordID{batch, index}, event_time, &out);
  *out_batch = out.batch_id;
  *out_index = out.index;
  return existing;
}

int pk2_update(void* h, const uint8_t* key, int32_t batch, uint32_t index) {
  return static_cast<PartitionedCuckoo*>(h)->update(key,
                                                    RecordID{batch, index})
             ? 1
             : 0;
}

void pk2_delete(void* h, const uint8_t* key) {
  static_cast<PartitionedCuckoo*>(h)->erase(key);
}

void pk2_classify(void* h, const uint8_t* keys, int n,
                  const uint8_t* key_valid, const int64_t* event_times,
                  int64_t cutoff, int64_t retention_ts, int64_t future_ts,
                  int32_t next_batch, uint32_t next_index,
                  uint32_t batch_capacity, uint8_t* actions,
                  int32_t* out_batch, uint32_t* out_index,
                  int32_t* out_counts) {
  static_cast<PartitionedCuckoo*>(h)->classify(
      keys, n, key_valid, event_times, cutoff, retention_ts, future_ts,
      next_batch, next_index, batch_capacity, actions, out_batch, out_index,
      out_counts);
}

int64_t pk2_dump(void* h, uint8_t* keys_out, int32_t* batch_out,
                 uint32_t* index_out, int64_t cap) {
  return static_cast<PartitionedCuckoo*>(h)->dump(keys_out, batch_out,
                                                  index_out, cap);
}

// one-shot growth before chunked classification (see reserve/presize_for)
void pk2_reserve(void* h, int64_t extra) {
  static_cast<PartitionedCuckoo*>(h)->reserve(extra);
}

void cuckoo_reserve(void* h, int64_t extra) {
  static_cast<CuckooIndex*>(h)->reserve(extra);
}

// Fused gather+scatter for columnar ingestion writes:
// dst[dst_idx[i]] = src[src_idx[i]] row-wise (row_bytes per row).
// Replaces numpy's temp-gather + fancy-scatter pair on the hot live-VP
// write path (reference role: memstore/ingestion.go writeBatchRecords);
// runs with the GIL released via ctypes.
void scatter_rows(uint8_t* dst, const uint8_t* src, const int64_t* dst_idx,
                  const int64_t* src_idx, int64_t n, int64_t row_bytes) {
  switch (row_bytes) {
    case 1:
      for (int64_t i = 0; i < n; i++) dst[dst_idx[i]] = src[src_idx[i]];
      return;
    case 2: {
      auto* d = reinterpret_cast<uint16_t*>(dst);
      auto* s = reinterpret_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < n; i++) d[dst_idx[i]] = s[src_idx[i]];
      return;
    }
    case 4: {
      auto* d = reinterpret_cast<uint32_t*>(dst);
      auto* s = reinterpret_cast<const uint32_t*>(src);
      for (int64_t i = 0; i < n; i++) d[dst_idx[i]] = s[src_idx[i]];
      return;
    }
    case 8: {
      auto* d = reinterpret_cast<uint64_t*>(dst);
      auto* s = reinterpret_cast<const uint64_t*>(src);
      for (int64_t i = 0; i < n; i++) d[dst_idx[i]] = s[src_idx[i]];
      return;
    }
    default:
      for (int64_t i = 0; i < n; i++)
        memcpy(dst + dst_idx[i] * row_bytes, src + src_idx[i] * row_bytes,
               row_bytes);
  }
}

}  // extern "C"
