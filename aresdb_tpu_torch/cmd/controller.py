"""Controller daemon (reference: cmd/controller fx app).

    python -m aresdb_tpu_torch.cmd.controller --port 9474 --root-path ctrl

Port of `aresdb_tpu/cmd/controller.py`: the same flags, served by the
port's ControllerServer on `http.server`. `--port 0` takes a free port,
which the start-up line names.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ares-controller", description=__doc__)
    p.add_argument("--port", type=int, default=9474)
    p.add_argument("--root-path", default="")
    p.add_argument("--instance", default="",
                   help="instance name for HA leader election")
    p.add_argument("--elect", action="store_true",
                   help="run lease-based leader election over --root-path "
                        "(start 2+ replicas on the same root for HA)")
    p.add_argument("--lease-ttl", type=float, default=3.0)
    args = p.parse_args(argv)

    from aresdb_tpu_torch.controller.server import ControllerServer
    from aresdb_tpu_torch.controller.state import ControllerState

    state = ControllerState(args.root_path or None)
    server = ControllerServer(
        state, port=args.port,
        instance_name=args.instance or f"controller-{args.port}",
        # on --port 0 the elector advertises the port bound
        advertise=f"localhost:{args.port}" if args.port else "",
        elect=args.elect, lease_ttl=args.lease_ttl)
    server.bind()
    print(f"ares-controller serving on :{server.port}"
          + (" (HA election on)" if args.elect else ""), file=sys.stderr,
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
