"""Build the native CPU engine shared library.

Usage: python -m superman_tpu.native.build [--force]
The library is also built lazily on first use (bindings/native.py).
Concurrent first uses (test workers, processes of one run) serialise on
a lock file and publish the library with an atomic rename, so no
process ever loads a half-written file.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "perman_cpu.cpp")
LIB = os.path.join(os.path.dirname(__file__), "libsuperman_cpu.so")


def _fresh() -> bool:
    return (os.path.exists(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(SRC))


def build(force: bool = False) -> str:
    if not force and _fresh():
        return LIB
    with open(LIB + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or not _fresh():
            tmp = f"{LIB}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-march=native", "-funroll-loops",
                   "-fopenmp", "-shared", "-fPIC", SRC, "-o", tmp]
            try:
                subprocess.run(cmd, check=True)
                os.replace(tmp, LIB)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
