"""Build and bind the stage, wire, aggregate, forge, batch-verify and tool
kernels (csrc/*.cu).

Each kernel source is compiled by its own `nvcc` process, all started
together, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>.<digest>.so <name>.cu

and loaded with ctypes (pointers and the stream as c_void_p). Outputs go
to the package's `_build/` directory (listed in .gitignore), named by a
digest of the sources so a stale library is never loaded; ptxas's
register / local-memory report for each kernel lands beside it as
`<name>.<digest>.ptxas.txt`. The same lane bodies build with g++ (-DPK_HOST)
into `host_emu.so` for the CPU cross-check of the device code.

`csrc/consts.cuh` is generated from the Python field/hash modules by
`render_consts()`; a test holds the committed file to the rendering.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build",
)
# kernel source (csrc/<name>.cu) -> its C entry points (the launchers
# first; each shipped kernel's `pk_<name>_attributes` beside them)
ENTRIES = {
    "ed": ("pk_ed", "pk_ed_attributes"),
    "ed_verify": ("pk_ed_verify", "pk_ed_verify_attributes"),
    "ed_verify_stamps": ("pk_ed_verify_stamps",),  # the instrument: ed_verify with clock64 stamps
    "kes": ("pk_kes", "pk_kes_attributes"),
    "vrf_prep": ("pk_vrf_prep", "pk_vrf_prep_attributes"),
    "vrf_bc_prep": ("pk_vrf_bc_prep", "pk_vrf_bc_prep_attributes"),
    "vrf_ladders": ("pk_vrf_ladders", "pk_vrf_ladders_attributes"),
    "finish": ("pk_finish", "pk_finish_attributes"),
    "unpack": ("pk_unpack", "pk_unpack_attributes"),
    "nonce_fold": ("pk_nonce_fold", "pk_b2b_bench", "pk_nonce_fold_attributes"),
    "primitives": ("pk_prim_sha", "pk_prim_shav", "pk_prim_b2b", "pk_prim_base",
                   "pk_prim_lad", "pk_prim_dec", "pk_prim_red", "pk_primitives_attributes"),
    "fe_bench": ("pk_fe_bench", "pk_fe_bench_attributes"),
    "agg_prep": ("pk_agg_prep", "pk_agg_prep_attributes"),
    "agg_stamps": ("pk_agg_prep_stamps",),  # the instrument: agg_prep with clock64 stamps
    "dedupe": ("pk_dedupe", "pk_dedupe_attributes"),
    "dedupe_stamps": ("pk_dedupe_stamps",),  # the instrument: dedupe with clock64 stamps
    "msm": ("pk_msm", "pk_msm_attributes"),
    "forge": ("pk_forge_sweep", "pk_ed_sign", "pk_forge_attributes", "pk_ed_sign_attributes"),
    "forge_stamps": ("pk_forge_sweep_stamps",),  # the instrument: the sweep with clock64 stamps
    "ed_sign_stamps": ("pk_ed_sign_stamps",),  # the instrument: the signer with clock64 stamps
}
KERNELS = tuple(ENTRIES)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_Z = ctypes.c_size_t
_DEDUPE = [_I, _I] + [_P] * 8 + [_Z] + [_P] * 4  # pk_dedupe up to its stream
ARGTYPES = {
    "pk_ed": [_I, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "pk_ed_verify": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "pk_ed_verify_stamps": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "pk_kes": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "pk_vrf_prep": [_I] + [_P] * 7,
    "pk_vrf_bc_prep": [_I] + [_P] * 10,
    "pk_vrf_ladders": [_I] + [_P] * 6,
    "pk_finish": [_I] + [_P] * 16,
    "pk_unpack": [_I, ctypes.POINTER(_I)] + [_P] * 12,
    "pk_nonce_fold": [_I, _I] + [_P] * 5,
    "pk_b2b_bench": [_I, _I] + [_P] * 4,
    "pk_prim_sha": [_I] + [_P] * 3,
    "pk_prim_shav": [_I, _P, _I, _P, _P, _P],
    "pk_prim_b2b": [_I] + [_P] * 3,
    "pk_prim_base": [_I] + [_P] * 4,
    "pk_prim_lad": [_I] + [_P] * 4,
    "pk_prim_dec": [_I] + [_P] * 4,
    "pk_prim_red": [_I] + [_P] * 4,
    "pk_fe_bench": [_I, _I, _I, _P, _P, _P],
    "pk_agg_prep": [_I, _I, _I, _I, ctypes.POINTER(_P)] + [_P] * 6,
    "pk_agg_prep_stamps": [_I, _I, _I, _I, ctypes.POINTER(_P)] + [_P] * 7,
    "pk_dedupe": _DEDUPE + [_P],
    "pk_dedupe_stamps": _DEDUPE + [_P, _P],
    "pk_msm": [_I, _I, _I, _I] + [_P] * 21,
    "pk_forge_sweep": [_I, _I, ctypes.c_longlong] + [_P] * 5,
    "pk_forge_sweep_stamps": [_I, _I, ctypes.c_longlong] + [_P] * 6,
    "pk_ed_sign": [_I, _I] + [_P] * 10,
    "pk_ed_sign_stamps": [_I, _I] + [_P] * 11,
    # each kernel's figures into int out[4] (pk.cuh `pk_func_attributes`)
    **{e: [ctypes.POINTER(_I)] for es in ENTRIES.values() for e in es
       if e.endswith("_attributes")},
    # host build only: fe_sq over [10, B] limb columns, the one-thread
    # Blake2b-256 over [B, 128] messages
    "pk_fe_sq": [_I] + [_P] * 3,
    "pk_b2b_one": [_I] + [_P] * 3,
    # host build only: msm's Horner chain on the warp and on one thread
    "pk_msm_horner": [_I] + [_P] * 4,
    # host build only: the signer's R = r·B (its teams' walks and sums)
    # over [B, 32] scalars -> [B, 40] limbs
    "pk_ed_sign_walk": [_I] + [_P] * 3,
    # host build only: sc_mul and sc_add over [B, 32] byte rows
    "pk_sc_mul": [_I] + [_P] * 3,
    "pk_sc_add": [_I] + [_P] * 3,
    # host build only: agg_prep's inversion tree over 64 [10] limb rows, and
    # sc_reduce512 over [B, 64] byte rows
    "pk_agg_inv_tree": [_P, _P],
    "pk_sc_reduce": [_I, _P, _P],
    # host build only: the dedupe's blocks in a given order, its launch's
    # blocks, scratch bytes and tickets at B lanes, and its slots' mod-L
    # row (agg_table_row) over [R, 32] int64 column sums
    "pk_dedupe_order": [_I] + _DEDUPE + [_P],
    "pk_dedupe_shape": [_I, _P],
    "pk_agg_tables": [_I, _P, _P, _P],
}
# the instruments and the runtime's attribute queries: no host build
DEVICE_ONLY = ("pk_agg_prep_stamps", "pk_dedupe_stamps", "pk_ed_verify_stamps",
               "pk_forge_sweep_stamps", "pk_ed_sign_stamps",
               *(e for e in ARGTYPES if e.endswith("_attributes")))
# a LAUNCHES name whose source holds two kernels -> (its source, the stem
# of its occupancy and attributes entries)
LAUNCH_SOURCE = {"forge_sweep": ("forge", "forge"), "ed_sign": ("forge", "ed_sign")}
# the kernel function each attributes and occupancy entry reads, as
# ptxas names it in its report (chip_smoke.py holds the two together)
ATTRIBUTE_KERNEL = {
    "ed": "ed_kernel", "ed_verify": "ed_verify_kernel", "kes": "kes_kernel",
    "vrf_prep": "vrf_prep_kernel", "vrf_bc_prep": "vrf_bc_prep_kernel",
    "vrf_ladders": "vrf_ladder_kernel", "finish": "finish_kernel", "unpack": "unpack_kernel",
    "nonce_fold": "nonce_fold_kernel", "primitives": "k_lad", "fe_bench": "fe_bench_kernelILi0E",
    "agg_prep": "agg_prep_kernel", "dedupe": "dedupe_kernel", "msm": "msm_chunk_kernel",
    "forge_sweep": "forge_sweep_kernel", "ed_sign": "ed_sign_kernel",
}

_LIBS: dict = {}
# wall seconds from the start of the parallel build to each source's nvcc exit
BUILD_SECONDS: dict = {}


def render_consts() -> str:
    """The device constant tables, rendered from the Python modules."""
    from . import field as fe
    from . import hashes as ph
    from . import verify as pv

    def fe_row(name, x):
        vals = ", ".join(f"0x{v:07x}u" for v in fe.int_to_limbs(x))
        return f"PK_CONST uint32_t {name}[10] = {{{vals}}};"

    two_p = [2 * ((1 << w) - 1) for w in fe.W]
    two_p[0] = 2 * ((1 << 26) - 19)
    lines = [
        "// Generated by ops/pk/build.py:render_consts() — do not edit.",
        "#pragma once",
        "#include <stdint.h>",
        "#ifdef PK_HOST",
        "#define PK_CONST static const",
        "#else",
        "#define PK_CONST __constant__ const",
        "#endif",
        "PK_CONST uint32_t PK_TWO_P[10] = {"
        + ", ".join(f"0x{v:07x}u" for v in two_p) + "};",
        fe_row("PK_D", fe.D),
        fe_row("PK_D2", fe.D2),
        fe_row("PK_SQRT_M1", fe.SQRT_M1),
        fe_row("PK_A", pv.MONT_A),
        fe_row("PK_NEG_A", -pv.MONT_A),
        fe_row("PK_A2", pv._A2),
        fe_row("PK_C2A2", pv._C2A2),
        fe_row("PK_SQRT_2I", pv.SQRT_2I),
        fe_row("PK_SQRT_M2I", pv.SQRT_M2I),
        "PK_CONST uint8_t PK_L_BYTES[32] = {"
        + ", ".join(str(b) for b in fe.L_BYTES) + "};",
        "PK_CONST uint64_t PK_SHA512_H0[8] = {"
        + ", ".join(f"0x{v:016x}ull" for v in ph.SHA512_H0) + "};",
        "PK_CONST uint64_t PK_SHA512_K[80] = {",
    ]
    for i in range(0, 80, 4):
        lines.append("    " + ", ".join(
            f"0x{v:016x}ull" for v in ph.SHA512_K[i:i + 4]) + ",")
    lines.append("};")
    lines.append("PK_CONST uint8_t PK_B2B_SIGMA[10][16] = {")
    for row in ph.B2B_SIGMA:
        lines.append("    {" + ", ".join(str(v) for v in row) + "},")
    lines.append("};")
    lines.append("// the same rows as compile-time constants: index k in nibble 15 - k")
    for r, row in enumerate(ph.B2B_SIGMA):
        lines.append(f"#define PK_B2B_SIGMA_NIB{r} 0x{''.join(f'{v:x}' for v in row)}ull")
    return "\n".join(lines) + "\n"


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build_cuda() -> dict:
    """Compile every kernel (parallel nvcc processes); -> {name: path}.
    Raises with the compiler's output when any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    dg = _digest()
    out = {k: os.path.join(BUILD_DIR, f"{k}.{dg}.so") for k in KERNELS}
    todo = [k for k in KERNELS
            if not (os.path.exists(out[k]) and os.path.exists(ptxas_report(k)))]
    from ...obs.warmup import WARMUP

    for k in KERNELS:
        if k not in todo and k not in WARMUP.builds:
            WARMUP.note_build(k, 0.0, cached=True)
    procs = {}
    t0 = time.monotonic()
    for k in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{k}.cu")]
        log = open(ptxas_report(k), "w")
        procs[k] = (tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True))
    failed = []
    while procs:
        for k, (tmp, log, p) in list(procs.items()):
            if p.poll() is None:
                continue
            BUILD_SECONDS[k] = time.monotonic() - t0
            WARMUP.note_build(k, BUILD_SECONDS[k])
            log.close()
            del procs[k]
            if p.returncode != 0:
                with open(ptxas_report(k)) as f:
                    failed.append(f"--- {k} ---\n{f.read()}")
                os.remove(tmp)
            else:
                os.replace(tmp, out[k])
        time.sleep(0.1)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def ptxas_report(name: str) -> str:
    """Path of ptxas's report for the current sources' build of `name`."""
    return os.path.join(BUILD_DIR, f"{name}.{_digest()}.ptxas.txt")


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        paths = build_cuda()
        for k, path in paths.items():
            if k not in _LIBS:
                lib = ctypes.CDLL(path)
                for entry in ENTRIES[k]:
                    fn = getattr(lib, entry)
                    fn.restype = ctypes.c_int
                    fn.argtypes = ARGTYPES[entry]
                _LIBS[k] = lib
    return _LIBS[name]


def kernel_lib(name: str, entry: str | None = None):
    """The launcher `entry` (default: the first) of kernel source `name`,
    building on first use."""
    return getattr(_lib(name), entry or ENTRIES[name][0])


def occupancy(name: str, kernel: str | None = None) -> dict:
    """Resident blocks per SM of one kernel source at its launch geometry
    (128 threads: ed, kes, ed_verify; vrf_prep, vrf_bc_prep and finish 96, vrf_ladders and
    unpack 256; agg_prep 320; msm's chunk phase 128; dedupe 256; forge's
    sweep 128),
    with its shared memory, from the CUDA occupancy API (registers, stack
    and shared memory); for a source with several kernels, its heaviest,
    or `kernel`'s (forge: "ed_sign"). -> blocks_per_sm, and the
    block_threads and dynamic_shared_bytes the entry asked it at (pk.cuh
    `pk_occupancy`)."""
    fn = getattr(_lib(name), f"pk_{kernel or name}_occupancy")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"{name}: occupancy query failed: cudaError {rc}")
    return {"blocks_per_sm": out[0], "block_threads": out[1], "dynamic_shared_bytes": out[2]}


def blocks_per_sm(name: str, kernel: str | None = None) -> int:
    """`occupancy`'s resident blocks per SM."""
    return occupancy(name, kernel)["blocks_per_sm"]


def kernel_figures(name: str) -> dict:
    """One launched kernel's own figures (`name` a LAUNCHES key): its
    registers, local bytes, static shared bytes and max threads a block
    from its `pk_<name>_attributes` entry, and its blocks per SM at the
    launch geometry, with that geometry (`occupancy`)."""
    source, stem = LAUNCH_SOURCE.get(name, (name, name))
    out = (ctypes.c_int * 4)()
    rc = kernel_lib(source, f"pk_{stem}_attributes")(out)
    if rc != 0:
        raise RuntimeError(f"{name}: attribute query failed: cudaError {rc}")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "max_threads": out[3], **occupancy(source, None if stem == source else stem)}


def build_host_emu() -> ctypes.CDLL:
    """g++ build of the lane bodies as host code (PK_HOST)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"host_emu.{_digest()}.so")
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            # -fno-aggressive-loop-optimizations: without it g++ 12 at -O1
            # makes sha512_msg's loop over a byte source that reads a
            # caller's local array (src(k) only where k < N, so always in
            # bounds) run forever
            subprocess.run(
                ["g++", "-O1", "-fno-aggressive-loop-optimizations", "-std=c++17", "-shared",
                 "-fPIC", "-DPK_HOST", "-Wno-unknown-pragmas", "-I", CSRC, "-o", tmp,
                 os.path.join(CSRC, "host_emu.cpp")],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(path)
    for entry, args in ARGTYPES.items():
        if entry in DEVICE_ONLY:
            continue
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib
