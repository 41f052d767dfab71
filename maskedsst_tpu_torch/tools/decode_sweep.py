"""Registers, local memory and grid sweep of the SimMIM decode kernels'
tensor-core forms on the card.

    python -m maskedsst_tpu_torch.tools.decode_sweep [--parent DIR]

Prints, one line each: ``nvcc -Xptxas -v``'s registers, stack and spills of
every kernel in ``csrc/fused_simmim_fwd.cu`` and ``csrc/fused_simmim_bwd.cu``
and the local-memory loads and stores (LDL, STL) in their SASS
(``cuobjdump -sass``); then, at the batch-64 bf16 training shapes of EnMAP
(20 spectral blocks) and Houston2018 (5), each kernel's device time
(torch.profiler, its reduction included) for several b's a block, each
setting held against the plain version first (loss relative to |plain|
< 1e-3, gradients relative to their max|plain| < 3e-2), and the fp32 (FMA)
forms' times. With ``--parent DIR`` (a checkout of an earlier tree), both
kernels of DIR's ``maskedsst_tpu_torch/csrc`` are built and timed beside
this tree's in one process, in the order parent, change, change, parent,
with the parent's grid rule (one 256-thread block per g and range of batch
rows, ``_grid``): bf16 and fp32 compute at both shapes. The last line is
one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from maskedsst_tpu_torch.ops import _build, fused_embed, fused_simmim
from maskedsst_tpu_torch.utils.profiling import card_line, device_ms

PERS = (1, 2, 3, 4, 5, 6, 8)
FWD_NAMES = ("fused_simmim_fwd", "sum_partials")
BWD_NAMES = ("fused_simmim_bwd", "reduce_partials")


def compiler_report(name: str, out_dir: Path) -> list:
    """(kernel, registers, stack bytes, spill stores, spill loads, LDL, STL)
    of each kernel of ``csrc/<name>.cu``."""
    lib = out_dir / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
           str(_build.CSRC / f"{name}.cu")]
    ptxas = subprocess.run(cmd, capture_output=True, text=True, check=True)
    rows, current = {}, None
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = rows.setdefault(m.group(1), {"kernel": m.group(1)})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    for chunk in sass.split("Function : ")[1:]:
        fn = chunk.split()[0]
        if fn in rows:
            rows[fn].update(ldl=len(re.findall(r"\bLDL\b", chunk)),
                            stl=len(re.findall(r"\bSTL\b", chunk)))
    return list(rows.values())


def inputs(b, g, n, d, p, device):
    gen = torch.Generator().manual_seed(0)
    enc = torch.randn(b, g, n, d, generator=gen).to(device, torch.bfloat16)
    patches = torch.randn(b, g, p, n, generator=gen).to(device)
    kern = (torch.randn(g, d, p, generator=gen) / math.sqrt(d)).to(device)
    bias = (0.1 * torch.randn(g, p, generator=gen)).to(device)
    weights = (torch.rand(b, g * n, generator=gen) < 0.7).float().to(device)
    return enc, patches, kern, bias, weights


def errors(args, gout, dtype) -> tuple:
    """(loss error relative to |plain|, worst gradient error relative to its
    max|plain|) of one call of each kernel."""
    got = float(fused_simmim._launch(*args, dtype))
    want = float(fused_simmim.fused_decode_l1_reference(*args, dtype))
    grads = fused_simmim._launch_bwd(*args, gout, dtype)
    plain = fused_simmim.fused_decode_l1_reference_bwd(*args, gout, dtype)
    gerr = max(float((a.float() - c.float()).abs().max()) / float(c.float().abs().max())
               for a, c in zip(grads, plain))
    return abs(got - want) / abs(want), gerr


def sweep(label, b, g, n, d, p, device) -> list:
    args = inputs(b, g, n, d, p, device)
    gout = torch.tensor(1.9e-9, device=device)
    bf = torch.bfloat16
    rows = []
    default = fused_simmim._plan
    sms = fused_embed.sm_count(device)
    for names, fn in ((FWD_NAMES, lambda: fused_simmim._launch(*args, bf)),
                      (BWD_NAMES, lambda: fused_simmim._launch_bwd(*args, gout, bf))):
        chunks, per, _ = default(b, g, n, p, d, bf, sms)
        split = [device_ms(fn, names=(name,)) for name in names]
        rows.append(dict(shape=label, kernel=names[0], per=per, split_ms=split))
        print(f"     {label} {names[0]}: chunk_plan gives {per} b's a block, {chunks} chunks; "
              f"device ms {split[0]:.4f} + {names[1]} {split[1]:.4f}", flush=True)
    try:
        for per in PERS:
            chunks = -(-b // per)
            blocks = g * fused_embed.tile_groups(n) * chunks
            fused_simmim._plan = lambda *a, _c=chunks, _p=per, _n=blocks: (_c, _p, _n)
            lerr, gerr = errors(args, gout, bf)
            fwd = device_ms(lambda: fused_simmim._launch(*args, bf), names=FWD_NAMES)
            bwd = device_ms(lambda: fused_simmim._launch_bwd(*args, gout, bf), names=BWD_NAMES)
            ok = lerr < 1e-3 and gerr < 3e-2
            rows.append(dict(shape=label, per=per, blocks=blocks, fwd_ms=fwd, bwd_ms=bwd,
                             loss_err=lerr, grad_err=gerr, ok=ok))
            print(f"{'ok  ' if ok else 'FAIL'} {label} {per} b's a block ({blocks} blocks): fwd "
                  f"{fwd:.4f} ms, bwd {bwd:.4f} ms; loss rel {lerr:.2e}, grads {gerr:.2e}",
                  flush=True)
    finally:
        fused_simmim._plan = default
    f32 = [t.float() if t.dtype == bf else t for t in args]
    fwd = device_ms(lambda: fused_simmim._launch(*f32, torch.float32), names=FWD_NAMES)
    bwd = device_ms(lambda: fused_simmim._launch_bwd(*f32, gout, torch.float32), names=BWD_NAMES)
    rows.append(dict(shape=label, dtype="float32", fwd_ms=fwd, bwd_ms=bwd))
    print(f"     {label} fp32 (FMA forms): fwd {fwd:.4f} ms, bwd {bwd:.4f} ms", flush=True)
    return rows


def parent_libs(parent: Path, out_dir: Path) -> dict:
    """{name: (library, entry)} of the parent tree's two decode kernels,
    built by nvcc with this tree's flags and bound as ``_bind`` binds."""
    csrc = parent / "maskedsst_tpu_torch" / "csrc"
    libs = {}
    for name, n_pointers in (("fused_simmim_fwd", 7), ("fused_simmim_bwd", 9)):
        so = out_dir / f"parent_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / f"{name}.cu")]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        libs[name] = (lib, _build.bind(lib, name, n_pointers=n_pointers, n_ints=9))
    return libs


def alternate(libs: dict, label, b, g, n, d, p, device) -> list:
    """Device ms of the parent's and this tree's kernels, bf16 and fp32
    compute, in the order parent, change, change, parent."""
    enc, *rest = inputs(b, g, n, d, p, device)
    gout = torch.tensor(1.9e-9, device=device)
    own_bind, own_plan = fused_simmim._bind, fused_simmim._plan

    def parent_plan(b, g, n, p, d, compute_dtype, sms):
        chunks, per = fused_simmim._grid(b, g, sms)
        return chunks, per, g * chunks

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        args = (enc.to(dtype), *rest)
        readings = {"parent": [], "change": []}
        for tree in ("parent", "change", "change", "parent"):
            if tree == "parent":
                fused_simmim._bind, fused_simmim._plan = libs.__getitem__, parent_plan
            try:
                fwd = device_ms(lambda: fused_simmim._launch(*args, dtype), names=FWD_NAMES)
                bwd = device_ms(lambda: fused_simmim._launch_bwd(*args, gout, dtype),
                                names=BWD_NAMES)
            finally:
                fused_simmim._bind, fused_simmim._plan = own_bind, own_plan
            readings[tree].append((fwd, bwd))
        name = str(dtype).split(".")[1]
        for tree, pairs in readings.items():
            rows.append(dict(shape=label, dtype=name, tree=tree, fwd_ms=[f for f, _ in pairs],
                             bwd_ms=[w for _, w in pairs]))
            print(f"     {label} {name} {tree}: fwd " + " / ".join(f"{f:.4f}" for f, _ in pairs)
                  + " ms, bwd " + " / ".join(f"{w:.4f}" for _, w in pairs) + " ms", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the tree to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        report = [r for name in ("fused_simmim_fwd", "fused_simmim_bwd")
                  for r in compiler_report(name, Path(tmp))]
        for r in report:
            print(f"     {r}", flush=True)
        for label, g in (("enmap", 20), ("houston", 5)):
            rows += sweep(label, 64, g, 64, 96, 10, "cuda")
        if args.parent is not None:
            libs = parent_libs(args.parent, Path(tmp))
            for label, g in (("enmap", 20), ("houston", 5)):
                rows += alternate(libs, label, 64, g, 64, 96, 10, "cuda")
    print(card_line())
    print(json.dumps({"decode_sweep": {"device": torch.cuda.get_device_name(0),
                                       "compiler": report, "rows": rows}}))
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
