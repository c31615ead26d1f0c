"""Build of the host C++ libraries under native/ (SA-IS, CHD, finish, SAM).

Each library is one C++ source compiled with g++ into a shared object with a
plain C interface, loaded with ctypes. The build goes into
`ma_tpu_torch/_build/` at first use; the file name carries a digest of the
source and the flags, so an edited source is rebuilt and nothing is written
beside the sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

NATIVE = Path(__file__).resolve().parent
BUILD = NATIVE.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def shared_library(source: str) -> ctypes.CDLL:
    """Compile native/<source> (once per digest of source and flags) and
    load it. Raises if g++ fails."""
    src = NATIVE / source
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    so = BUILD / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    if not so.is_file():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
