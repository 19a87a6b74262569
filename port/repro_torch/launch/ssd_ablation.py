"""Where the SSD intra-chunk kernel's time goes: the kernel timed with
one phase taken out at a time, on the card.

    python -m repro_torch.launch.ssd_ablation        # from port/, one CUDA card

Each variant is the kernel's own source (``kernels/ssd/csrc/ssd.cu``)
with statements removed by text substitution, built with ``nvcc`` as
the kernel is (``kernels/cuda_build.py``) into the build directory, and
launched through the same C interface at Mamba2-1.3B's prefill shape
(B = 4, L = 32,768, H = 64, P = 64, G = 1, S = 128, Q = 128), on seeded
random inputs.  Every variant but ``full`` computes a wrong answer by
design; only the times mean anything.  The variants:

    full          the kernel as shipped
    no_split      X_h is not split into hi / lo (stale operands)
    no_next_load  the next head's X_h, cl and dt are not staged
    one_term      Y = M . X_h with the hi . hi term only
    no_product    no Y = M . X_h and no stores
    product_only  no staging and no split: the product on stale data
    split_only    staging of the first head and the splits only

Prints one JSON line a variant and round (CUDA-event ms over 10
launches, two rounds in turn), then the card's name and power limit as
``nvidia-smi`` gives them.  A substitution that no longer matches the
source raises: keep the anchors in step with ``ssd.cu``.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from ..kernels import cuda_build
from ..kernels.ssd import kernel

SPLIT = "    split_head(smem, m);\n"
NEXT = """    if (hh + 1 < d.run) {
      stage_head(smem, m, (hh + 1) & 1, x, dt, cl, t0, h0 + hh + 1, d);
      cp_async_commit();
    }
"""
PRODUCT = """    if (live_a) y_strip<false>(acc, sa, smem, m, hh & 1, y, t0, h0 + hh, d);
    if (live_b) y_strip<true>(acc, sb, smem, m, hh & 1, y, t0, h0 + hh, d);
"""
CORRECTIONS = """#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt)
          if (n0 + 8 * nt < d.p)
            mma(ya[nt], a.lo, __float_as_uint(bx[nt].x),
                __float_as_uint(bx[nt].y));
#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt)
          if (n0 + 8 * nt < d.p)
            mma(ya[nt], a.hi, __float_as_uint(bx[nt].z),
                __float_as_uint(bx[nt].w));
"""
VARIANTS = {
    "full": (),
    "no_split": (SPLIT,),
    "no_next_load": (NEXT,),
    "one_term": (CORRECTIONS,),
    "no_product": (PRODUCT,),
    "product_only": (SPLIT, NEXT),
    "split_only": (NEXT, PRODUCT),
}
SHAPE = dict(bs=4, l=32_768, h=64, p=64, g=1, s=128, q=128)


def variant_source(cuts) -> str:
    src = kernel.SOURCE.read_text()
    for cut in cuts:
        if src.count(cut) != 1:
            raise RuntimeError(f"ssd_ablation: an anchor no longer matches "
                               f"ssd.cu once: {cut[:60]!r}")
        src = src.replace(cut, "")
    return src


def build(variants: dict) -> dict:
    """Compile every variant at once -> {name: library path}."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, []
    for name, cuts in variants.items():
        src = variant_source(cuts)
        tag = hashlib.sha256(src.encode()).hexdigest()[:12]
        cu = cuda_build.BUILD_DIR / f"ssd_ablation_{name}-{tag}.cu"
        lib = cu.with_suffix(".so")
        paths[name] = lib
        if not lib.exists():
            cu.write_text(src)
            procs.append((name, subprocess.Popen(
                [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
    return paths


def inputs(dev: torch.device):
    b, l, h, p, g, s, q = (SHAPE[k] for k in "bs l h p g s q".split())
    gen = torch.Generator(dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(b, l, h, p)
    dt = torch.nn.functional.softplus(normal(b, l, h)) * 0.1
    cl = torch.cumsum((-dt * 0.5).reshape(b, l // q, q, h), 2).reshape(
        b, l, h)
    return x, dt, cl, normal(b, l, g, s) * 0.3, normal(b, l, g, s) * 0.3


def launcher(path, args, dev: torch.device):
    """The variant's launch as a closure over its own library and the
    heads a block serves at its own occupancy."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in kernel.LIB.signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    x, dt, cl, b, c = args
    bs, l, h, p = x.shape
    g, s, q = b.shape[2], b.shape[3], SHAPE["q"]
    version, index = kernel.VERSIONS["intra_chunk"], dev.index or 0
    resident = ctypes.c_int(0)
    if lib.ssd_resident_blocks(version, index, q, p, s,
                               ctypes.byref(resident)):
        raise RuntimeError("ssd_resident_blocks failed")
    run = kernel.heads_per_block(bs * (l // q) * g, h // g, resident.value)
    y = torch.empty_like(x)

    def launch():
        err = lib.ssd_intra_chunk(
            version, index, x.data_ptr(), dt.data_ptr(), cl.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), bs, l, h, g, q, p, s,
            run, cuda_build.stream(dev))
        if err:
            raise RuntimeError(f"launch failed: {err}")
    return launch, resident.value, run


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_ablation needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    paths = build(VARIANTS)
    args = inputs(dev)
    launches = {name: launcher(path, args, dev)
                for name, path in paths.items()}
    for rnd in range(2):
        for name, (fn, resident, run) in launches.items():
            print(json.dumps(dict(variant=name, round=rnd, ms=cuda_ms(fn),
                                  resident_blocks=resident,
                                  heads_per_block=run, **SHAPE)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
