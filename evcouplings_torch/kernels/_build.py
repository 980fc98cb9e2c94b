"""
Build the port's native sources (evcouplings_torch/csrc/) and load them
with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). A CUDA source
<name>.cu is built by nvcc for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/evcouplings_torch/<name>-<key>.so csrc/<name>.cu

and a host source <name>.c by the C compiler (cc -O2 -shared -fPIC
-ffp-contract=off): the sequential-dot host chain and the alignment
readers (fasta_io.c, stockholm_io.c). `key` hashes the source, the
headers beside it (.cuh and .h) and the flags, so an edited source or
header never loads a stale library. Libraries
are built at first use, or all at once (one compiler process per source,
in parallel) by build_all(). Every CUDA entry point returns the
cudaError_t of its launch; check_launch() turns a non-zero code into an
exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/evcouplings_torch (build/ is git-ignored)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "evcouplings_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# host sources: no contraction of a*b+c, so every fused multiply-add is
# one the source asks for
CC_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")

# libraries loaded in this process, by source name
_loaded = {}


class KernelBuildError(RuntimeError):
    """A compiler failed, or a built library lacks an expected symbol."""


def find_nvcc():
    """Path of nvcc: PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def find_cc():
    """Path of the host C compiler: $CC, then cc, gcc, clang on PATH."""
    for c in (os.environ.get("CC"), "cc", "gcc", "clang"):
        path = c and shutil.which(c)
        if path:
            return path
    raise KernelBuildError(
        "no C compiler found ($CC, cc, gcc, clang); the host helpers "
        "cannot be built")


def _source(name):
    """csrc/<name>.cu if it exists, else csrc/<name>.c."""
    cu = CSRC_DIR / (name + ".cu")
    return cu if cu.exists() else CSRC_DIR / (name + ".c")


def library_path(name):
    """Where the library of csrc/<name>.{cu,c} is built, keyed on
    content: the source, every header in csrc/ (.cuh and .h) and the
    flags."""
    src = _source(name)
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS if src.suffix == ".cu"
                      else CC_FLAGS).encode())
    headers = sorted(CSRC_DIR.glob("*.cuh")) + sorted(CSRC_DIR.glob("*.h"))
    for p in [src] + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / "{}-{}.so".format(name, h.hexdigest()[:16])


def _start_compiler(name, out):
    """Start the compiler for one source; the output lands under a
    temporary name and is renamed into place by _finish (atomic for
    concurrent builders)."""
    tmp = out.with_name(out.name + ".tmp{}".format(os.getpid()))
    src = _source(name)
    if src.suffix == ".cu":
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    else:
        cmd = [find_cc(), *CC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, cmd


def _finish(name, proc, tmp, out, cmd):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(
            "compiling {} failed (rc {}):\n{}\n{}".format(
                name, proc.returncode, " ".join(cmd), log)
        )
    os.replace(tmp, out)


def build_all(names):
    """Build every named source that has no current library, one compiler
    process per source, all started together. Returns the paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {n: library_path(n) for n in names}
    running = [
        (n, *_start_compiler(n, out)) for n, out in outs.items()
        if not out.exists()
    ]
    for n, proc, tmp, cmd in running:
        _finish(n, proc, tmp, outs[n], cmd)
    return outs


def load(name, functions, restype=ctypes.c_int):
    """Load the library of csrc/<name>.{cu,c} (building it if needed).

    functions: {symbol: argtypes}; every symbol returns `restype` (for
    CUDA sources a C int, the cudaError_t of the launch). Raises
    KernelBuildError if a symbol is missing.
    """
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        if _source(name).suffix == ".cu":
            lib.evc_error_string.argtypes = [ctypes.c_int]
            lib.evc_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    for symbol, argtypes in functions.items():
        try:
            fn = getattr(lib, symbol)
        except AttributeError as e:
            raise KernelBuildError(
                "{} has no symbol {}".format(name, symbol)) from e
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_launch(lib, err, what):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            what, err, lib.evc_error_string(err).decode()))


def stream_of(tensor):
    """PyTorch's current stream on the tensor's device, as a c_void_p."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)
