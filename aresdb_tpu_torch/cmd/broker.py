"""Broker daemon (reference: cmd/broker/cmd/cmd.go:43 aresbrokerd).

    python -m aresdb_tpu_torch.cmd.broker --port 9574 \
        --controller localhost:9474 --namespace prod

Port of `aresdb_tpu/cmd/broker.py`: the same flags, served by the port's
BrokerServer on `http.server`. `--port 0` takes a free port, which the
start-up line names.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ares-broker", description=__doc__)
    p.add_argument("--port", type=int, default=9574)
    p.add_argument("--controller", required=True,
                   help="controller host:port")
    p.add_argument("--namespace", required=True)
    args = p.parse_args(argv)

    from aresdb_tpu_torch.broker.server import BrokerServer
    from aresdb_tpu_torch.broker.validator import BrokerSchemaView
    from aresdb_tpu_torch.cluster.topology import DynamicTopology

    topo = DynamicTopology(args.controller, args.namespace)
    topo.start()
    schema_view = BrokerSchemaView(args.controller, args.namespace)
    schema_view.start()
    server = BrokerServer(topo, port=args.port, schema_view=schema_view)
    server.bind()
    print(f"ares-broker serving on :{server.port}", file=sys.stderr,
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        schema_view.stop()
        topo.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
