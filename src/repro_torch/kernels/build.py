"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` (all started
together) into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>.so csrc/<name>.cu

The libraries land in ``build/repro_torch_kernels/<hash>/`` at the root
of the checkout, keyed by a hash of every source in ``csrc/`` and the
flags, so an edited source is rebuilt and an unchanged one is not.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside each library as ``<name>.log``.  Nothing is built when this
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{name: {"path", "seconds", "built", "log"}}``; raises with
    the compiler's output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources():
        lib = out_dir / f"{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".{src.stem}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib, time.perf_counter())
    # each compiler's output is read on a thread of its own, so that each
    # build's seconds end when that build does, not when the one before it
    # in this loop does
    done: dict[str, tuple[str, float]] = {}

    def drain(name: str, proc: subprocess.Popen, t0: float) -> None:
        log, _ = proc.communicate()
        done[name] = (log, time.perf_counter() - t0)

    threads = [threading.Thread(target=drain, args=(name, proc, t0))
               for name, (proc, _, _, t0) in procs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report: dict[str, dict] = {}
    failed = []
    for name, (proc, tmp, lib, _) in procs.items():
        log, seconds = done[name]
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        report[name] = {"path": str(lib), "seconds": seconds, "built": True, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for src in sources():
        if src.stem not in report:
            log_file = out_dir / f"{src.stem}.log"
            report[src.stem] = {"path": str(out_dir / f"{src.stem}.so"), "seconds": 0.0,
                                "built": False,
                                "log": log_file.read_text() if log_file.exists() else ""}
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_dir() / f"{name}.so"
        if not path.exists():
            build_all()
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
