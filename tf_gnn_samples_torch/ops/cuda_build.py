"""Builds and loads the port's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes. Each kernel declares the headers its
source includes and the C signature of its entry point (`KERNELS`;
`<name>_launch`, or the name `ENTRY` gives). Libraries are named by a
hash of the source, its headers and the flags, under
`build/torch_kernels/` at the repository root (listed in .gitignore), so
a changed source rebuilds and an unchanged one is reused. Nothing is
built at import time: the first wrapper call on a CUDA tensor builds what
it needs; `build_all()` builds every kernel at once, one nvcc process per
source, all started together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "torch_kernels")
_P, _I = ctypes.c_void_p, ctypes.c_int
# The FiLM kernels' entry point: (two inputs, ranks, out, num_edges, dim,
# act id, stream).
_FILM_ARGS = (_P,) * 4 + (_I,) * 3 + (_P,)
# The per-head weighted segment-sums (K7a, K7b, K13a, K13b) share their
# device code; the forward walks K1's rows (film_rows.cuh).
_WSEG_HEADERS = ("wseg_common.cuh", "film_rows.cuh", "film_common.cuh")
# K1-K4, K15a and K15b share their device code (film_rows.cuh); the K16
# variants of K1 and K2 share those two's earlier walk (film_walk.cuh).
_ROWS_HEADERS = ("film_rows.cuh", "film_common.cuh")
_WALK_HEADERS = ("film_walk.cuh", "film_common.cuh")
# K10a, K10b and K14 form their typed products on the tensor cores through
# one tile (typed_mma.cuh).
_MMA_HEADERS = ("typed_mma.cuh", "film_common.cuh")
# name -> (headers the source includes, argument types of its entry
# point); every entry point returns the CUDA error code of its launch.
KERNELS: Dict[str, Tuple[Tuple[str, ...], Tuple[type, ...]]] = {
    # msgs, ranks, out, num_edges, dim, stream type id, stream
    "segsum": (("film_common.cuh",), (_P,) * 3 + (_I,) * 3 + (_P,)),
    # table, ranks, out, num_edges, dim, stream
    "expand": ((), (_P,) * 3 + (_I,) * 2 + (_P,)),
    "film_fwd": (_ROWS_HEADERS, _FILM_ARGS),
    # msgs, gb, g, ranks, dgb, num_edges, dim, ld_gb, ld_g, act id, stream
    "film_bwd_dgb": (_ROWS_HEADERS, (_P,) * 5 + (_I,) * 5 + (_P,)),
    # gcb, gb, g, fine, t, t_index, ranks, dt, num_edges, dim, ld_gb, ld_g,
    # rpad, t_rows, act id, stream (the stream form: null gb, g, fine,
    # t_index; the gather form: null gcb)
    "film_src_bwd": (_ROWS_HEADERS, (_P,) * 8 + (_I,) * 7 + (_P,)),
    # msgs_t, ranks, out, num_edges, rows, num_heads, stream
    "segsum_t": (("film_common.cuh",), (_P,) * 3 + (_I,) * 3 + (_P,)),
    # table_t, ranks, out, num_edges, rows, num_heads, stream
    "expand_t": ((), (_P,) * 3 + (_I,) * 3 + (_P,)),
    # msgs, w_t, ranks, out, num_edges, dim, dim_in, num_heads, stream
    "wseg_t": (_WSEG_HEADERS, (_P,) * 4 + (_I,) * 4 + (_P,)),
    # msgs, w_t, g16, ranks, dmsg, dw_t, num_edges, dim, num_heads, stream
    "wseg_t_bwd": (_WSEG_HEADERS, (_P,) * 6 + (_I,) * 3 + (_P,)),
    # msgs, gb, g, ranks, dmsg, dgb, num_edges, dim, ld_gb, ld_g, act id,
    # stream
    "film_bwd": (_ROWS_HEADERS, (_P,) * 6 + (_I,) * 5 + (_P,)),
    # msgs, g16, ranks, dw_t, num_edges, dim, dim_in, num_heads, stream
    "wseg_t_dw": ((), (_P,) * 4 + (_I,) * 4 + (_P,)),
    # gcb, side, fine, t_ext, ranks, out, num_edges, dim, num_heads, rpad,
    # clamp, stream (the stream form: null side and fine; the gather form:
    # null gcb)
    "rgat_src_bwd": (("film_common.cuh",),
                     (_P,) * 6 + (_I,) * 4 + (ctypes.c_float, _P)),
    # m, beta, ranks, x, num_edges, dim, act id, stream
    "expand_add_act": (("film_common.cuh",), _FILM_ARGS),
    # x, dx, ranks, dm, dbeta, num_edges, dim, act id, stream
    "expand_add_act_bwd": (("film_common.cuh",),
                           (_P,) * 5 + (_I,) * 3 + (_P,)),
    # act_agg_slices_launch: host arrays of the slices' message pointers,
    # rank pointers and edge counts, the slice count, out, dim, act id,
    # stream
    "act_agg": (_ROWS_HEADERS, (_P,) * 3 + (_I, _P, _I, _I, _P)),
    # act_agg_bwd_slices_launch: host arrays of the slices' message, rank
    # and output pointers and edge counts, the slice count, g16, dim, act
    # id, stream
    "act_agg_bwd": (("film_common.cuh",), (_P,) * 4 + (_I, _P, _I, _I, _P)),
    # x, w, types, ranks, out, num_edges, dh, dim, num_types, act id, stream
    "typed_dense_agg": (_MMA_HEADERS, (_P,) * 5 + (_I,) * 5 + (_P,)),
    # x, w, g16, types, ranks, dx, dw, num_edges, dh, dim, num_types, act
    # id, stream
    "typed_dense_agg_bwd": (_MMA_HEADERS, (_P,) * 7 + (_I,) * 5 + (_P,)),
    # gcb, t, type_col, w, e_real, ranks, out, num_edges, dim, l_eff, act
    # id, stream
    "emlp1_src_bwd": (_MMA_HEADERS, (_P,) * 7 + (_I,) * 4 + (_P,)),
    # msgs, w, ranks, out, num_edges, dim, num_heads, stream
    "wseg": (_WSEG_HEADERS, (_P,) * 4 + (_I,) * 3 + (_P,)),
    # msgs, w, g16, ranks, dmsg, dw, num_edges, dim, num_heads, stream
    "wseg_bwd": (_WSEG_HEADERS, (_P,) * 6 + (_I,) * 3 + (_P,)),
    # msgs, gb, ranks, out, mask, num_edges, dim, lanes, act id, stream
    "film_fwd_mask": (_ROWS_HEADERS, (_P,) * 5 + (_I,) * 4 + (_P,)),
    # mask, c, ranks, side, out, num_edges, dim, lanes, table_rows, leak,
    # stream
    "masked_segsum": (_ROWS_HEADERS,
                      (_P,) * 5 + (_I,) * 4 + (ctypes.c_float, _P)),
    # The earlier designs of K3 and K4 (tools/earlier_designs.py), on no
    # model path: gcb, t, ranks, dt, num_edges, dim, act id, stream; msgs,
    # gbg, ranks, dmsg, dgb, num_edges, dim, act id, stream
    "film_src_bwd_walk": (("film_common.cuh",), _FILM_ARGS),
    "film_bwd_walk": (("film_common.cuh",), (_P,) * 5 + (_I,) * 3 + (_P,)),
    # The earlier designs of K12a and K9: msgs, ranks, out, num_edges, dim,
    # act id, stream; gcb, t_ext, ranks, out, num_edges, dim, num_heads,
    # clamp, stream
    "act_agg_walk": (("film_common.cuh",), (_P,) * 3 + (_I,) * 3 + (_P,)),
    # The earlier design of K12b, one launch a slice: msgs, g16, ranks,
    # dmsg, num_edges, dim, act id, stream
    "act_agg_bwd_per_slice": (("film_common.cuh",), _FILM_ARGS),
    "rgat_src_bwd_walk": (("film_common.cuh",),
                          (_P,) * 4 + (_I,) * 3 + (ctypes.c_float, _P)),
    # The earlier designs of K7a and K6a: msgs, w_t, ranks, out, num_edges,
    # dim, dim_in, num_heads, stream; msgs_t, ranks, out, num_edges, rows,
    # num_heads, stream
    "wseg_t_walk": (("film_common.cuh",), (_P,) * 4 + (_I,) * 4 + (_P,)),
    "segsum_t_walk": (("film_common.cuh",), (_P,) * 3 + (_I,) * 3 + (_P,)),
    # The earlier designs of K10a and K10b: x, w, types, ranks, out,
    # num_edges, dh, dim, num_types, act id, stream; x, w, wt (w
    # transposed), g16, types, ranks, dx, dw, num_edges, dh, dim,
    # num_types, act id, stream
    "typed_dense_agg_scalar": (("film_common.cuh",),
                               (_P,) * 5 + (_I,) * 5 + (_P,)),
    "typed_dense_agg_bwd_scalar": (("film_common.cuh",),
                                   (_P,) * 8 + (_I,) * 5 + (_P,)),
    # The earlier designs of K14, K15a and K15b: gcb, t, type_col, w, wt
    # (w transposed), e_real, ranks, out, num_edges, dim, l_eff, act id,
    # stream; msgs, gb, ranks, out, mask, num_edges, dim, lanes, act id,
    # stream; mask, c, ranks, out, num_edges, dim, lanes, leak, stream
    "emlp1_src_bwd_scalar": (("film_common.cuh",),
                             (_P,) * 8 + (_I,) * 4 + (_P,)),
    "film_fwd_mask_walk": (("film_common.cuh",),
                           (_P,) * 5 + (_I,) * 4 + (_P,)),
    "masked_segsum_walk": (("film_common.cuh",),
                           (_P,) * 4 + (_I,) * 3 + (ctypes.c_float, _P)),
    # K16, the A/B variants of tools/ (tf_gnn_samples_torch/tools/):
    # msgs, gb, ranks, out, num_edges, dim, act id, variant, group, stream
    "film_fwd_ab": (_WALK_HEADERS, (_P,) * 4 + (_I,) * 5 + (_P,)),
    # msgs, gbg, ranks, dgb, num_edges, dim, act id, variant, group, stream
    "film_dgb_ab": (_WALK_HEADERS, (_P,) * 4 + (_I,) * 5 + (_P,)),
    # table, idx, starts, out, num_out, dim, rows, elem bytes, variant,
    # win, stream
    "rowgather": ((), (_P,) * 4 + (_I,) * 6 + (_P,)),
}
# Entry points not named <name>_launch.
ENTRY = {"act_agg": "act_agg_slices_launch",
         "act_agg_bwd": "act_agg_bwd_slices_launch"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each kernel built by
# this process; empty for a library found already built.
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (name + ".cu",) + KERNELS[name][0]:
        with open(os.path.join(CSRC, f), "rb") as src:
            h.update(src.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel of `names` not built yet, in parallel.
    Returns {name: library path}; raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        jobs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode,
                                                      out))
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def entry(name: str) -> str:
    """The C entry point of kernel `name`."""
    return ENTRY.get(name, name + "_launch")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed, with the
    argument types of its entry point set from `KERNELS`."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        fn = getattr(lib, entry(name))
        fn.argtypes = list(KERNELS[name][1])
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
