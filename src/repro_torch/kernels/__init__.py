"""Hand-written CUDA kernels for Hopper (``sm_90a``): the partitioner's
three hot loops and the serving path's prefill attention, and the module
that builds and loads them.

  pins_count  — per-edge partition pin counts (refinement, every repetition)
  gains       — per-node connection weights to every partition (refinement)
  pair_scores — per-node neighbour histogram eta + inbound intersection
                inter in slot space (coarsening, every level that fits)
  flash_attn  — online-softmax GQA attention (LM prefill, every layer)

Each subpackage holds ``ops.py`` (tile bounds, the ``fits_kernel``
predicate and the wrapper) and ``ref.py`` (the plain PyTorch version of the
same function). The CUDA sources live in ``repro_torch/csrc/``.

Dispatch contract
-----------------

* A partitioner kernel runs only under ``use_kernels=True`` and behind its
  ``fits_kernel`` predicate, as in the JAX package: a level whose extents
  exceed the level-0 tile bounds takes the plain segment path
  (``coarsen.score_slots``, ``refine.conn_segments``,
  ``refine.pins_matrix``), and ``PartitionResult.kernel_path`` counts the
  branch taken exactly as the JAX package counts it. flash_attn runs on
  every prefill attention whose tensors lie on a CUDA device.
* Inside a wrapper the tensors' device decides, never
  ``torch.cuda.is_available()``: tensors on the CPU run the plain version,
  tensors on a CUDA device launch the kernel or raise. Nothing catches a
  failed build or launch to fall back.
* Every launch adds one to ``LAUNCHES[name]``; nothing else does.
* On a mesh (``ctx`` a sharded ``segops.ShardCtx``) each shard launches
  the kernel on its contiguous row stripe (node rows for pair_scores and
  gains, edge rows for pins_count), counted under ``name + "_stripe"``,
  and the stripes concatenate in shard order (``ctx.gather``; for gains,
  the moves ``refine.propose_moves`` derives from its rows): disjoint
  rows, and per-row arithmetic that does not depend on the stripe, so the
  bits are one device's. ``fits_kernel`` combines per-stripe counts with
  an integer ``psum`` against the same bounds on every mesh, so the
  branch taken, and ``kernel_path``, do not depend on the mesh.

Build
-----

``library()`` compiles every ``csrc/*.cu`` with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3`` (one ``nvcc`` per source, all started
together) and links them into one shared library with a plain C interface,
loaded with ``ctypes``. The build goes to ``build/repro_torch/<hash>/`` at
the root of the checkout, keyed by a hash of the sources and flags, at
first use, with ptxas's report of each kernel's registers and spills
(``ptxas_log()``). Each C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``. ``pins_count_launch`` also
takes its launch shape from ``pins_count/ops.py::tile_plan`` (edge rows a
tile, counter buffers, grid) and raises its kernel's dynamic
shared-memory limit itself when the buffers need more than 48 KB.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# a partitioner kernel's launches on one stripe of a sharded level count
# under "<name>_stripe", apart from its whole-level launches; flash_attn's
# launches in its two modes also count under "flash_attn_offset" (query rows
# at an offset into the keys' positions) and "flash_attn_p_bf16"
LAUNCHES = {"pair_scores": 0, "pins_count": 0, "gains": 0,
            "flash_attn": 0, "pair_scores_stripe": 0,
            "pins_count_stripe": 0, "gains_stripe": 0,
            "flash_attn_offset": 0, "flash_attn_p_bf16": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: (argument types) -> cudaError_t as int
_SIGNATURES = {
    # edge_off, edge_pins, edge_nsrc, parts, pins, pins_in,
    # ecap, ncap, kcap, row0, nrows, te, stages, grid, stream
    "pins_count_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    # node_off, node_edges, edge_off, edge_pins, parts, edge_w, pins, conn,
    # ncap, ecap, kcap, h, wide, row0, nrows, stream
    "gains_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _P],
    # node_off, node_edges, node_nin, edge_off, edge_pins, edge_nsrc,
    # edge_w, nbr_off, nbr_ids, eta, inter, ncap, ecap, nbcap, bins,
    # row0, nrows, tail, stream
    "pair_scores_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, batch, q_seq, k_seq, heads, kv_heads, head_dim, causal,
    # q_offset, p_bf16, scale, dtype (0 f32, 1 bf16), stream
    "flash_attn_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build(out_dir: Path) -> Path:
    """Compile every source to an object in parallel, then link."""
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir.parent, prefix=".tmp-"))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors, logs = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"{src.name}:\n{out}")
            if p.returncode != 0:
                errors.append(logs[-1])
        (tmp / "ptxas.log").write_text("\n".join(logs))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        so = tmp / "librepro_kernels.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so), *map(str, sorted(tmp.glob("*.o")))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp, out_dir)  # atomic: a concurrent build loses the race
    except OSError:
        if not out_dir.exists():
            raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / "librepro_kernels.so"


def _out_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def ptxas_log() -> str:
    """ptxas's report on every kernel of the built library."""
    library()
    return (_out_dir() / "ptxas.log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = _out_dir()
        so = out_dir / "librepro_kernels.so"
        if not so.exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            so = _build(out_dir)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, counter: str, *args) -> None:
    """Call the C entry point ``name`` on the current CUDA stream, count the
    launch under ``counter`` and raise on a nonzero ``cudaError_t``."""
    lib = library()
    fn = getattr(lib, name)
    if len(args) + 1 != len(fn.argtypes):  # ctypes would pass extras as int
        raise TypeError(f"{name} takes {len(fn.argtypes) - 1} arguments "
                        f"and the stream, got {len(args)}")
    # the current device's stream; naming the device by its index skips
    # the slow lookup that current_stream() makes without one
    stream = torch.cuda.current_stream(
        torch.cuda.current_device()).cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.repro_error_string(err).decode()}")
    LAUNCHES[counter] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None, device: torch.device | None = None):
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements exceed int32 indexing")
