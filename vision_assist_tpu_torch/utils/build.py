"""Compile one source file of the package into a shared library, at first use.

The libraries have plain C entry points and are loaded with ctypes, so no
PyTorch header is compiled and a build takes seconds. They go into
``.torch_ext_build/`` at the repository root (git-ignored), under a name that
carries a hash of the source and the flags, so a changed source is rebuilt
and an unchanged one is reused.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import re
import shutil
import subprocess

BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def compile_shared(compiler: str, flags: list[str], source: pathlib.Path,
                   stem: str) -> tuple[pathlib.Path, str, bool]:
    """``compiler flags -o <lib> source`` unless the library for this source
    and these flags is already there. Returns (library path, compiler
    output, whether the compiler ran); the output is kept beside the library
    and returned again when the library is reused. Raises RuntimeError with
    that output when the compiler fails."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join([compiler, *flags]).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{stem}_{tag}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else "", False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed building {source}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, log, True


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_entries(log: str) -> list[dict]:
    """Each kernel ``ptxas -v`` reports in ``log``: its mangled name,
    registers a thread, stack frame, spill stores and spill loads (bytes;
    summed over every function ptxas lists with it)."""
    out = []
    for block in re.split(r"ptxas info\s*: (?=Compiling entry function)", log)[1:]:
        name, regs = _ENTRY.match(block), _REGS.search(block)
        frames = [[int(x) for x in f] for f in _FRAME.findall(block)]
        if name and regs:
            out.append({"name": name.group(1), "registers": int(regs.group(1)),
                        "stack": sum(f[0] for f in frames),
                        "spill_stores": sum(f[1] for f in frames),
                        "spill_loads": sum(f[2] for f in frames)})
    return out
