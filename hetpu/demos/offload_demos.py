"""Client / server / rookie demos (reference ``client.cpp``/``server.cpp``/
``client_server_rookie.cpp``): run ``server <name>`` in one shell and
``client <name>`` in another (loopback port scan 8080-8100), or
``client_server_rookie <name>`` for the in-process pipe."""

from __future__ import annotations

import threading

import numpy as np

from ..offload.client import Client
from ..offload.server import serve_once
from ..runtime import native
from ..utils import Timer


def _params_for(name, small):
    if name in ("inv", "inv_sqrt_twice", "abs", "twice_max"):
        return "test_deep" if small else "ckks_deep"
    if name == "fft":
        return "test_deep" if small else "ckks_fft"
    return "test_tiny" if small else "ckks_small"


def _run_client(name, t, small):
    """Run one client workload; returns (decrypted result, expected)."""
    cl = Client(_params_for(name, small), galois_steps=[1])
    rng = np.random.default_rng(0)
    slots = cl.sess.slots
    tm = Timer()
    if name == "simple":
        x1, x2 = rng.uniform(-1, 1, slots), rng.uniform(-1, 1, slots)
        got, want = cl.simple(t, x1, x2), x1 * x2
        tm.toc("offload simple time")
        print("op1*op2 =", got.real[:4], "\nexpected =", want[:4])
    elif name == "batch_matmul":
        a = rng.uniform(-1, 1, (5, 5, slots))
        b = rng.uniform(-1, 1, (5, 5, slots))
        got = cl.batch_matmul(t, a, b)
        tm.toc("offload batch_matmul time")
        want = np.einsum("ikb,kjb->ijb", a, b)
        got = got[:, :, :slots]
        print("max err =", np.abs(got.real - want).max())
    elif name == "inv":
        x = rng.uniform(0.5, 1.5, slots)
        got, want = cl.inv(t, x, 0.8, 5), 1 / x
        tm.toc("offload inv time")
        print("1/x =", got.real[:4], "\nexpected =", want[:4])
    elif name == "inv_sqrt_twice":
        x = rng.uniform(0.4, 0.7, slots)
        got, want = cl.inv_sqrt_twice(t, x, 1.0, 4), 1 / np.sqrt(2 * x)
        tm.toc("offload inv_sqrt_twice time")
        print("1/sqrt(2x) =", got.real[:4], "\nexpected =", want[:4])
    elif name == "abs":
        x = rng.uniform(0.5, 1.0, slots) * rng.choice([-1, 1], slots)
        got, want = cl.abs(t, x, 1.0, 4), np.abs(x)
        tm.toc("offload abs time")
        print("|x| =", got.real[:4], "\nexpected =", want[:4])
    elif name == "twice_max":
        x1, x2 = rng.uniform(-1, 1, slots), rng.uniform(-1, 1, slots)
        got, want = cl.twice_max(t, x1, x2, 1.0, 4), 2 * np.maximum(x1, x2)
        tm.toc("offload twice_max time")
        print("2max =", got.real[:4], "\nexpected =", want[:4])
    elif name == "fft":
        n = 8 if small else 32
        sig = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        got, want = cl.fft(t, sig), np.fft.fft(sig)
        tm.toc("offload fft time")
        print("max err =", np.abs(got - want).max())
    else:
        raise SystemExit(f"unknown client demo {name!r}")
    return got, want


def demo_client(name, small=False):
    t = native.connect()
    try:
        return _run_client(name, t, small)
    finally:
        t.close()


def demo_server(name=None, small=False):
    print(f"listening on 127.0.0.1:{native.PORT_LO}-{native.PORT_HI} ...")
    w = serve_once()
    print(f"served workload {w!r}")


def serve_or_hang_up(t):
    """serve_once on ``t``; if the server fails, close ``t`` so the
    client's read ends with an error instead of waiting forever."""
    try:
        serve_once(t)
    except BaseException:
        t.close()
        raise


def demo_rookie(name, small=False):
    """Both roles in one process over a socketpair (reference
    client_server_rookie.cpp).  Returns (decrypted result, expected)."""
    ta, tb = native.pipe_pair()
    th = threading.Thread(target=serve_or_hang_up, args=(tb,))
    th.start()
    try:
        return _run_client(name, ta, small)
    finally:
        th.join()
        ta.close()
        tb.close()


CLIENT_DEMOS = ("simple", "batch_matmul", "inv", "inv_sqrt_twice", "abs",
                "twice_max", "fft")
