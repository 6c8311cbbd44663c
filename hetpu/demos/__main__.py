"""CLI dispatcher — parity with reference ``demo <suite> <name>``
(``src/demos/demos.cpp:7-29``).

Usage: python -m hetpu.demos <suite> <name> [--small] [--cpu]

``--cpu`` pins JAX to the host CPU (quick local checks with ``--small``).
The standalone ``client`` suite always runs on the CPU: in the offload
protocol the trusted client is a host, and the ``server`` process in the
other shell holds the GPU (one process per card).
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    small = "--small" in argv
    if "--cpu" in argv or (argv and argv[0] == "client"):
        import jax
        jax.config.update("jax_platforms", "cpu")
    argv = [a for a in argv if a not in ("--small", "--cpu")]
    if len(argv) < 1:
        print(__doc__)
        print("suites: bfv_operations client client_server_rookie fft "
              "math_operations matrix_operations server")
        return 1
    suite = argv[0]
    name = argv[1] if len(argv) > 1 else None

    if suite == "matrix_operations":
        from . import matrix_operations as m
    elif suite == "bfv_operations":
        from . import bfv_operations as m
    elif suite == "math_operations":
        from . import math_operations as m
    elif suite == "fft":
        from . import fft as m
    elif suite in ("client", "server", "client_server_rookie"):
        from . import offload_demos as o
        if suite == "server":
            o.demo_server(name, small)
        elif suite == "client":
            o.demo_client(name, small)
        else:
            o.demo_rookie(name, small)
        return 0
    else:
        print(f"unknown suite {suite!r}")
        return 1

    if name not in m.DEMOS:
        print(f"unknown demo {name!r}; available: {' '.join(m.DEMOS)}")
        return 1
    m.DEMOS[name](small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
