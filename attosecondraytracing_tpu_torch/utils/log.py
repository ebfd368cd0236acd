"""Console logging, banner, timers, and profiling helpers."""

from __future__ import annotations

import contextlib
import sys
import time

_BANNER = r"""
    _  _   _                              _    ___             _____            _
   /_\| |_| |_ ___ ___ ___ __ ___ _ _  __| |  | _ \__ _ _  _  |_   _| _ __ _ __(_)_ _  __ _
  / _ \  _|  _/ _ (_-</ -_) _/ _ \ ' \/ _` |  |   / _` | || |   | || '_/ _` / _| | ' \/ _` |
 /_/ \_\__|\__\___/__/\___\__\___/_||_\__,_|  |_|_\__,_|\_, |   |_||_| \__,_\__|_|_||_\__, |
                                                        |__/   PyTorch + CUDA        |___/
"""


def print_banner():
    from .. import __version__

    line = "_" * 99
    print(line)
    print(_BANNER, flush=True)
    print(f"v{__version__} (attosecondraytracing_tpu_torch)", flush=True)
    print(line)


def transient(msg: str):
    """Print a transient status message (overwritten by the next output)."""
    print(msg, end="", flush=True)


def clear_line():
    print("\r\033[K", end="", flush=True)


@contextlib.contextmanager
def timer(label: str = "Elapsed", out=sys.stdout):
    t0 = time.perf_counter()
    yield
    print(f"{label}: {time.perf_counter() - t0:.3f} s", file=out, flush=True)
