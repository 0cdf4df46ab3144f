"""Controller HTTP service.

Reference: controller/handlers/{namespace,schema,membership,placement,
assignment}.go route surface. Clients: datanodes (schema fetch + heartbeat +
placement watch), brokers (schema + placement), subscribers (assignment).

Port of `aresdb_tpu/controller/server.py` on `http.server`
(api/httpbase.py): every route of the JAX package's `make_app` in its
order, with its status codes and JSON bodies. A follower of an HA
election answers 503 with the leader's address, except on /leader and
/ui; so does a leader whose lease lapsed by its own clock, or whose
snapshot write the lease's fence refused (election.NotLeader), where the
JAX package's serves and writes; a KeyError in a handler is a 404, a
ValueError a 400, a malformed body tornado's 400 page. The handlers run
one at a time, under one lock, as the JAX package's run on its IOLoop.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from aresdb_tpu_torch.api.httpbase import (HTTPError, Handler, Service,
                                           compile_routes)
from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.controller.election import NotLeader
from aresdb_tpu_torch.controller.state import (ControllerState, Instance,
                                               JobConfig)


class ControllerContext:
    def __init__(self, state: ControllerState, elector=None):
        self.state = state
        self.elector = elector
        self.lock = threading.Lock()
        self.metrics = None


class _Base(Handler):
    serialized = True

    def __init__(self, ctx, request):
        super().__init__(ctx, request)
        self.state = ctx.state
        self.elector = ctx.elector

    def prepare(self):
        # HA mode: only the lease holder serves; followers answer 503 with
        # the leader's address so FailoverSession retries there (reference
        # leader_elector.go — only the elected controller runs tasks)
        if self.elector is not None and not self.elector.is_leader:
            self.not_leader()

    def not_leader(self):
        lease = self.elector.current_leader()
        self.write_json({"message": "not leader",
                         "leader": lease["address"] if lease else None}, 503)

    def body(self):
        try:
            return json.loads(self.request.body or b"{}")
        except json.JSONDecodeError as e:
            raise HTTPError(400, str(e))

    def guard(self, fn):
        try:
            return fn()
        except KeyError as e:
            self.write_json({"message": str(e)}, 404)
        except ValueError as e:
            self.write_json({"message": str(e)}, 400)
        except NotLeader:
            self.not_leader()


class NamespacesHandler(_Base):
    def get(self):
        self.write_json(self.state.list_namespaces())

    def post(self):
        name = self.body().get("namespace", "")
        self.guard(lambda: (self.state.create_namespace(name),
                            self.write_json({"message": "created"}))[-1])


class SchemaHandler(_Base):
    def get(self, ns: str):
        def run():
            tables = self.state.get_tables(ns)
            self.write_json([t.to_json() for t in tables.values()])
        self.guard(run)

    def post(self, ns: str):
        def run():
            self.state.create_table(ns, Table.from_json(self.body()))
            self.write_json({"message": "created"})
        self.guard(run)


class SchemaHashHandler(_Base):
    def get(self, ns: str):
        self.guard(lambda: self.write_json({"hash": self.state.get_hash(ns)}))


class TableHandler(_Base):
    def get(self, ns: str, table: str):
        def run():
            tables = self.state.get_tables(ns)
            if table not in tables:
                raise KeyError(f"unknown table {table!r}")
            self.write_json(tables[table].to_json())
        self.guard(run)

    def put(self, ns: str, table: str):
        def run():
            t = Table.from_json(self.body())
            if t.name != table:
                raise ValueError("table name mismatch")
            self.state.update_table(ns, t)
            self.write_json({"message": "updated"})
        self.guard(run)

    def delete(self, ns: str, table: str):
        self.guard(lambda: (self.state.delete_table(ns, table),
                            self.write_json({"message": "deleted"}))[-1])


class EnumHandler(_Base):
    def get(self, ns: str, table: str, column: str):
        self.guard(lambda: self.write_json(
            self.state.get_enums(ns, table, column)))

    def post(self, ns: str, table: str, column: str):
        cases = self.body().get("enumCases", [])
        self.guard(lambda: self.write_json(
            self.state.extend_enum(ns, table, column, cases)))


class MembershipHandler(_Base):
    def get(self, ns: str):
        def run():
            if self.get_argument("all", "") in ("1", "true"):
                # UI view: every registered instance with liveness — the
                # reference controller UI colors down instances red
                # (controller/ui/src/App.js statusColorMapping)
                alive = set(self.state.alive_instances(ns))
                out = {}
                for k, v in self.state.ns(ns).instances.items():
                    out[k] = {
                        "host": v.host, "port": v.port,
                        "alive": k in alive,
                        "lastHeartbeatAgoSec":
                            None if not v.last_heartbeat
                            else round(time.time() - v.last_heartbeat, 1),
                        "rows": int(sum(v.shard_rows.values())),
                    }
                self.write_json(out)
                return
            alive = self.state.alive_instances(ns)
            self.write_json({k: {"host": v.host, "port": v.port}
                             for k, v in alive.items()})
        self.guard(run)

    def post(self, ns: str):
        b = self.body()
        inst = Instance(name=b["name"], host=b["host"], port=int(b["port"]))
        self.guard(lambda: (self.state.join(ns, inst),
                            self.write_json({"message": "joined"}))[-1])


class HeartbeatHandler(_Base):
    def put(self, ns: str, name: str):
        shard_rows = self.body().get("shardRows") if self.request.body \
            else None
        self.guard(lambda: (self.state.heartbeat(ns, name, shard_rows),
                            self.write_json({"message": "ok"}))[-1])

    def delete(self, ns: str, name: str):
        self.guard(lambda: (self.state.leave(ns, name),
                            self.write_json({"message": "left"}))[-1])


class PlacementHandler(_Base):
    def get(self, ns: str, kind: str):
        def run():
            p = self.state.get_placement(ns, kind)
            self.write_json({
                "numShards": p.num_shards,
                "replicaFactor": p.replica_factor,
                "shards": [{"shardId": sa.shard_id, "instances": sa.instances}
                           for sa in p.shards],
            })
        self.guard(run)

    def post(self, ns: str, kind: str):
        b = self.body()

        def run():
            self.state.init_placement(
                ns, kind, int(b["numShards"]), int(b["replicaFactor"]),
                list(b["instances"]))
            self.write_json({"message": "initialized"})
        self.guard(run)


class PlacementReplaceHandler(_Base):
    """Elastic instance replacement (reference: m3 placement replace —
    the leaving instance keeps serving as a Leaving bootstrap source
    until the joiner marks its shards Available)."""

    def post(self, ns: str, kind: str):
        b = self.body()
        self.guard(lambda: (self.state.replace_instance(
            ns, kind, b["leaving"], b["joining"]),
            self.write_json({"message": "replacing"}))[-1])


class PlacementRebalanceHandler(_Base):
    """Skew-aware shard rebalance from heartbeat-reported row counts."""

    def post(self, ns: str, kind: str):
        self.guard(lambda: self.write_json(self.state.rebalance(ns, kind)))


class PlacementAvailableHandler(_Base):
    def post(self, ns: str, kind: str, instance: str):
        b = self.body()
        shard = b.get("shardId")
        self.guard(lambda: (self.state.mark_available(
            ns, kind, instance, None if shard is None else int(shard)),
            self.write_json({"message": "ok"}))[-1])


class JobsHandler(_Base):
    def get(self, ns: str):
        def run():
            jobs = self.state.ns(ns).jobs
            self.write_json([vars(j) for j in jobs.values()])
        self.guard(run)

    def post(self, ns: str):
        b = self.body()
        job = JobConfig(name=b["name"], table=b["table"], topic=b["topic"],
                        cluster=b.get("cluster", ""),
                        config=b.get("config", {}))
        self.guard(lambda: (self.state.add_job(ns, job),
                            self.write_json({"message": "added"}))[-1])


class JobConfigHandler(_Base):
    """Single job-config CRUD (reference: controller/handlers/config.go
    GetJob/UpdateJob/DeleteJob at /config/{namespace}/jobs/{job})."""

    def get(self, ns: str, name: str):
        def run():
            jobs = self.state.ns(ns).jobs
            if name not in jobs:
                return self.write_json({"message": "job not found"}, 404)
            self.write_json(vars(jobs[name]))
        self.guard(run)

    def put(self, ns: str, name: str):
        b = self.body()
        job = JobConfig(name=name, table=b["table"], topic=b["topic"],
                        cluster=b.get("cluster", ""),
                        config=b.get("config", {}))
        self.guard(lambda: (self.state.add_job(ns, job),
                            self.write_json({"message": "updated"}))[-1])

    def delete(self, ns: str, name: str):
        self.guard(lambda: (self.state.delete_job(ns, name),
                            self.write_json({"message": "deleted"}))[-1])


class AssignmentHandler(_Base):
    def get(self, ns: str, subscriber: str):
        def run():
            self.state.subscriber_heartbeat(ns, subscriber)
            jobs = self.state.get_assignment(ns, subscriber)
            self.write_json([vars(j) for j in jobs])
        self.guard(run)


class PlacementKindsHandler(_Base):
    """List placement kinds in a namespace (UI helper; the reference UI
    hard-codes the datanode placement — controller/ui/src/App.js
    fetchPlacement)."""

    def get(self, ns: str):
        self.guard(lambda: self.write_json(
            sorted(self.state.ns(ns).placements)))


CONTROLLER_UI = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>aresdb controller</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f4f5f7;color:#172b4d}
 header{background:#172b4d;color:#fff;padding:10px 18px;display:flex;
   align-items:center;gap:16px}
 header h1{font-size:16px;margin:0}
 nav button{background:none;border:none;color:#b3bac5;padding:8px 10px;
   cursor:pointer;font-size:14px}
 nav button.on{color:#fff;border-bottom:2px solid #4c9aff}
 main{padding:16px 18px}
 table{border-collapse:collapse;background:#fff;margin:8px 0}
 th,td{border:1px solid #dfe1e6;padding:4px 10px;font-size:13px;text-align:left}
 th{background:#f4f5f7}
 .chip{display:inline-block;border-radius:3px;color:#fff;padding:1px 7px;
   margin:1px;font-size:12px}
 .Available{background:#57d500}.Initializing{background:#ffbf00}
 .Leaving{background:#ff2e00}.down{background:#ff2e00}.up{background:#57d500}
 textarea{width:640px;height:300px;font:12px monospace}
 select,input{font-size:13px;padding:2px 4px}
 button.act{background:#0052cc;color:#fff;border:none;border-radius:3px;
   padding:4px 10px;margin:2px;cursor:pointer}
 button.danger{background:#de350b}
 #msg{color:#006644;font-size:13px;white-space:pre-wrap}
 .err{color:#bf2600 !important}
 ul{margin:4px 0;padding-left:18px}
 li a{cursor:pointer;color:#0052cc;text-decoration:underline;font-size:13px}
</style></head><body>
<header><h1>aresdb controller</h1>
 <span id="leader" style="font-size:12px"></span>
 <label style="font-size:13px">namespace
  <select id="ns" onchange="render()"></select></label>
 <input id="newns" placeholder="new namespace" size="12">
 <button class="act" onclick="createNs()">create</button>
 <nav id="tabs"></nav>
</header>
<main><div id="msg"></div><div id="view"></div></main>
<script>
const TABS=["tables","jobs","instances","placement","assignments"];
let tab="tables";
const $=id=>document.getElementById(id);
async function j(url,opt){const r=await fetch(url,opt);
 const t=await r.text();let b;try{b=JSON.parse(t)}catch(e){b=t}
 if(!r.ok)throw new Error(typeof b=="object"?JSON.stringify(b):b);return b}
function say(m,err){$("msg").textContent=m;
 $("msg").className=err?"err":""}
async function boot(){
 $("tabs").innerHTML=TABS.map(t=>
  `<button id="tab-${t}" onclick="tab='${t}';render()">${t}</button>`).join("");
 try{const l=await j("/leader");
  $("leader").textContent=l.mode=="single"?"single-node"
   :(l.isLeader?`leader (epoch ${l.epoch})`:`follower of ${l.leader}`);
 }catch(e){$("leader").textContent="?"}
 const nss=await j("/namespaces");
 $("ns").innerHTML=nss.map(n=>`<option>${n}</option>`).join("");
 render()}
async function createNs(){try{
 await j("/namespaces",{method:"POST",
  body:JSON.stringify({namespace:$("newns").value})});
 say("namespace created");boot()}catch(e){say(e.message,1)}}
function ns(){return $("ns").value}
async function render(){
 TABS.forEach(t=>$("tab-"+t).className=t==tab?"on":"");
 say("");if(!ns()){$("view").innerHTML="<i>no namespace</i>";return}
 await ({tables,jobs,instances,placement,assignments})[tab]()}

async function tables(){
 const ts=await j(`/schema/${ns()}/tables`);
 const h=await j(`/schema/${ns()}/hash`);
 $("view").innerHTML=`<b>schema hash</b> <code>${h.hash}</code>
  <ul>${ts.map(t=>`<li><a onclick='showTable(${JSON.stringify(t.name)})'>
    ${t.name}</a> (${t.columns.length} cols${t.isFactTable?", fact":""})
    </li>`).join("")}</ul>
  <textarea id="tj" placeholder="table JSON"></textarea><br>
  <button class="act" onclick="pushTable(false)">create</button>
  <button class="act" onclick="pushTable(true)">update</button>
  <button class="act danger" onclick="delTable()">delete</button>
  <div id="enums"></div>`}
async function showTable(name){
 const t=await j(`/schema/${ns()}/tables/${name}`);
 $("tj").value=JSON.stringify(t,null,1);
 const ecols=t.columns.filter(c=>(c.type||"").includes("Enum"));
 $("enums").innerHTML=ecols.length?"<b>enum columns:</b> "+ecols.map(c=>
  `<a onclick='showEnums(${JSON.stringify(name)},${JSON.stringify(c.name)})'>
   ${c.name}</a>`).join(" "):""}
async function showEnums(t,c){
 const e=await j(`/schema/${ns()}/tables/${t}/columns/${c}/enum-cases`);
 say(`${t}.${c} enum cases: ${JSON.stringify(e)}`)}
async function pushTable(update){try{
 const t=JSON.parse($("tj").value);
 if(update)await j(`/schema/${ns()}/tables/${t.name}`,
  {method:"PUT",body:JSON.stringify(t)});
 else await j(`/schema/${ns()}/tables`,
  {method:"POST",body:JSON.stringify(t)});
 say(update?"updated":"created");tables()}catch(e){say(e.message,1)}}
async function delTable(){try{
 const t=JSON.parse($("tj").value);
 await j(`/schema/${ns()}/tables/${t.name}`,{method:"DELETE"});
 say("deleted");tables()}catch(e){say(e.message,1)}}

async function jobs(){
 const js=await j(`/config/${ns()}/jobs`);
 $("view").innerHTML=`<ul>${js.map(x=>
   `<li><a onclick='showJob(${JSON.stringify(x.name)})'>${x.name}</a>
    → table ${x.table}, topic ${x.topic}</li>`).join("")}</ul>
  <textarea id="jj" placeholder="job JSON"></textarea><br>
  <button class="act" onclick="pushJob()">add / update</button>
  <button class="act danger" onclick="delJob()">delete</button>`}
async function showJob(name){
 const x=await j(`/config/${ns()}/jobs/${name}`);
 $("jj").value=JSON.stringify(x,null,1)}
async function pushJob(){try{
 const x=JSON.parse($("jj").value);
 await j(`/config/${ns()}/jobs/${x.name}`,
  {method:"PUT",body:JSON.stringify(x)});
 say("pushed");jobs()}catch(e){say(e.message,1)}}
async function delJob(){try{
 const x=JSON.parse($("jj").value);
 await j(`/config/${ns()}/jobs/${x.name}`,{method:"DELETE"});
 say("deleted");jobs()}catch(e){say(e.message,1)}}

async function instances(){
 const m=await j(`/membership/${ns()}/instances?all=1`);
 $("view").innerHTML=`<table><tr><th>instance</th><th>address</th>
  <th>status</th><th>last heartbeat</th><th>rows</th></tr>${
  Object.entries(m).map(([k,v])=>`<tr><td>${k}</td>
   <td>${v.host}:${v.port}</td>
   <td><span class="chip ${v.alive?"up":"down"}">${
     v.alive?"active":"down"}</span></td>
   <td>${v.lastHeartbeatAgoSec==null?"—":v.lastHeartbeatAgoSec+"s ago"}</td>
   <td>${v.rows}</td></tr>`).join("")}</table>`}

async function placement(){
 const kinds=await j(`/placements/${ns()}`);
 let html=`kind <select id="pk">${kinds.map(k=>`<option>${k}</option>`)
  .join("")}</select>
  <button class="act" onclick="showPlacement()">view</button>
  <button class="act" onclick="rebalance()">rebalance</button><br>
  replace: <input id="leaving" placeholder="leaving" size="10">
  <input id="joining" placeholder="joining" size="10">
  <button class="act" onclick="replaceInst()">replace</button><br>
  mark available: <input id="avinst" placeholder="instance" size="10">
  <input id="avshard" placeholder="shard (blank=all)" size="10">
  <button class="act" onclick="markAvail()">mark</button>
  <div id="pview"></div>`;
 $("view").innerHTML=html;if(kinds.length)showPlacement()}
async function showPlacement(){
 const p=await j(`/placement/${ns()}/${$("pk").value}`);
 $("pview").innerHTML=`<p>${p.numShards} shards × rf ${p.replicaFactor}</p>
  <table><tr><th>shard</th><th>instances</th></tr>${p.shards.map(s=>
   `<tr><td>${s.shardId}</td><td>${Object.entries(s.instances).map(
    ([i,st])=>`<span class="chip ${st}">${i}: ${st}</span>`).join("")}
   </td></tr>`).join("")}</table>`}
async function rebalance(){try{
 const r=await j(`/placement/${ns()}/${$("pk").value}/rebalance`,
  {method:"POST",body:"{}"});
 say("rebalance: "+JSON.stringify(r));showPlacement()}
 catch(e){say(e.message,1)}}
async function replaceInst(){try{
 await j(`/placement/${ns()}/${$("pk").value}/replace`,{method:"POST",
  body:JSON.stringify({leaving:$("leaving").value,
                       joining:$("joining").value})});
 say("replacing");showPlacement()}catch(e){say(e.message,1)}}
async function markAvail(){try{
 const b={};if($("avshard").value)b.shardId=+$("avshard").value;
 await j(`/placement/${ns()}/${$("pk").value}/${$("avinst").value}/available`,
  {method:"POST",body:JSON.stringify(b)});
 say("marked");showPlacement()}catch(e){say(e.message,1)}}

async function assignments(){
 $("view").innerHTML=`subscriber:
  <input id="sub" placeholder="subscriber name" size="14">
  <button class="act" onclick="showAssign()">fetch</button>
  <pre id="aview"></pre>`}
async function showAssign(){try{
 const a=await j(`/assignment/${ns()}/subscribers/${$("sub").value}`);
 $("aview").textContent=JSON.stringify(a,null,1)}catch(e){say(e.message,1)}}

setInterval(()=>{if(tab=="instances"||tab=="placement")render()},5000);
boot();
</script></body></html>"""


class ControllerUIHandler(_Base):
    """Controller web UI (reference: controller/ui npm React app —
    namespace selector, tables/jobs/instances/placement tabs with JSON
    editors and state-colored shard chips; rebuilt as one dependency-free
    page). Served by leaders and followers (the header shows which)."""

    def prepare(self):
        pass

    def get(self):
        self.set_header("Content-Type", "text/html")
        self.finish(CONTROLLER_UI)


class LeaderHandler(_Base):
    """Election status — served by leaders AND followers."""

    def prepare(self):
        pass

    def get(self):
        e = self.elector
        if e is None:
            self.write_json({"mode": "single", "isLeader": True})
            return
        lease = e.current_leader()
        self.write_json({
            "mode": "ha",
            "isLeader": e.is_leader,
            "name": e.name,
            "epoch": e.epoch,
            "leader": lease["address"] if lease else None,
        })


ROUTES = (
    (r"/leader", LeaderHandler),
    (r"/namespaces", NamespacesHandler),
    (r"/schema/([^/]+)/tables", SchemaHandler),
    (r"/schema/([^/]+)/hash", SchemaHashHandler),
    (r"/schema/([^/]+)/tables/([^/]+)", TableHandler),
    (r"/schema/([^/]+)/tables/([^/]+)/columns/([^/]+)/enum-cases",
     EnumHandler),
    (r"/membership/([^/]+)/instances", MembershipHandler),
    (r"/membership/([^/]+)/instances/([^/]+)", HeartbeatHandler),
    (r"/ui/?", ControllerUIHandler),
    (r"/placements/([^/]+)", PlacementKindsHandler),
    (r"/placement/([^/]+)/([^/]+)", PlacementHandler),
    (r"/placement/([^/]+)/([^/]+)/replace", PlacementReplaceHandler),
    (r"/placement/([^/]+)/([^/]+)/rebalance", PlacementRebalanceHandler),
    (r"/placement/([^/]+)/([^/]+)/([^/]+)/available",
     PlacementAvailableHandler),
    (r"/assignment/([^/]+)/jobs", JobsHandler),
    (r"/config/([^/]+)/jobs", JobsHandler),
    (r"/config/([^/]+)/jobs/([^/]+)", JobConfigHandler),
    (r"/assignment/([^/]+)/subscribers/([^/]+)", AssignmentHandler),
)
_COMPILED = compile_routes(ROUTES)


class ControllerServer(Service):
    def __init__(self, state: Optional[ControllerState] = None, port: int = 0,
                 root_path: Optional[str] = None, *,
                 instance_name: str = "", advertise: str = "",
                 elect: bool = False, lease_ttl: float = 3.0):
        self.state = state or ControllerState(root_path)
        self.elector = None
        if elect:
            from aresdb_tpu_torch.controller.election import LeaderElector

            if not self.state.root_path:
                raise ValueError("HA election requires a shared root_path")
            # a follower promoted to leader must pick up the previous
            # leader's persisted mutations before serving
            self.elector = LeaderElector(
                self.state.root_path, instance_name or advertise, advertise,
                ttl=lease_ttl, on_elected=self.state.reload)
            self.state.fence = self.elector.fenced
        super().__init__(ControllerContext(self.state, self.elector),
                         _COMPILED, port, name="ares-controller")

    def _start_elector(self) -> None:
        if self.elector is not None:
            if not self.elector.address:
                self.elector.address = f"localhost:{self.port}"
            self.elector.start()

    def start_background(self) -> int:
        port = super().start_background()
        self._start_elector()
        return port

    def serve_forever(self):
        """Serve on the caller's thread (the elector, if any, on its own)
        until interrupted; resigns the lease on the way out."""
        self.bind()
        self._start_elector()
        try:
            super().serve_forever()
        finally:
            if self.elector is not None:
                self.elector.stop()

    def stop(self):
        if self.elector is not None:
            self.elector.stop()
        self.shutdown()
