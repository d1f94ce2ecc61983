"""Ablations of the port's redesigned CUDA kernels on one card: what bounds
them.

    python3 benchmarks/torch_kernel_ablation.py

``ssd_chunk``: copies of ``src/repro_torch/csrc/ssd_scan.cu`` with one part
of the kernel cut out by a text substitution (each cut is asserted to
match, so a stale pattern fails loudly) are built with ``nvcc`` into
``build/ablation/`` and launched through the C interface, at the serving
shape and a full 256-row chunk. The time a cut saves is what that part
costs where it does not overlap the rest. Only the uncut kernel's outputs
mean anything; they are held against the plain version (bitwise flag and
max abs error). Beside them, the time PyTorch's own fill and copy kernels
take for the same output writes and input reads, a floor the card reaches
for this traffic. ``flash_attention``: both routes (bf16 tensor cores, f32
CUDA cores) at the two serving shapes, beside SDPA.

Times are device times: CUDA events around back-to-back launches through
ctypes (the loop issues faster than the kernels run), median of 7 runs of
50. One JSON line per measurement; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "ssd_scan.cu")
OUT = os.path.join(ROOT, "build", "ablation")

# name -> [(text in ssd_scan.cu, replacement), ...]. A store is cut with a
# guard that is false at run time (lc < 0), so that the compiler cannot
# drop the products that feed it as dead code.
CUTS = {
    "no products": [
        ("        mm4x4<kT, HD>(y_acc,", "        if (lc < 0) mm4x4<kT, HD>(y_acc,"),
        ("        if (last)\n          mm4x4<HD, N>(s_acc,",
         "        if (last && lc < 0)\n          mm4x4<HD, N>(s_acc,")],
    "no output stores": [
        ("          if (l < lc)\n", "          if (l < lc && lc < 0)\n"),
        ("      if (last && r0 < HD && c0 < N)\n",
         "      if (last && r0 < HD && c0 < N && lc < 0)\n")],
    "no exp in P": [("expf(cumh[lg] - cumh[mg])", "1.0f")],
}


def _variants():
    src = open(SRC).read()
    out = {"kernel": src}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"ablation '{name}': {old!r} does not occur "
                                 f"exactly once in {SRC}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(variants):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        cu = os.path.join(OUT, f"ssd_{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"ssd_{i}.so")
        procs[name] = (so, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for '{name}':\n{log}")
        libs[name] = so
    return libs


def events_ms(fn, reps: int = 50, iters: int = 7) -> float:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def ablate_ssd(libs, gen, stream):
    import torch
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref
    for shape in ((32, 80, 64, 64, 64), (4, 80, 256, 64, 64)):
        g, h, lc, n, hd = shape
        c, b = (torch.randn(g, lc, n, generator=gen, device="cuda")
                for _ in range(2))
        x = torch.randn(g, h, lc, hd, generator=gen, device="cuda")
        cum = -torch.randn(g, h, lc, generator=gen, device="cuda").abs() \
            .cumsum(-1)
        ry, rs = ssd_chunk_batched_ref(c, b, x, cum)
        # what the card takes for the kernel's own traffic alone: writing
        # y and s, and reading xdt while writing y and s
        y0, s0 = torch.empty_like(ry), torch.empty_like(rs)
        floors = {
            "write y and s (zero_)": lambda: (y0.zero_(), s0.zero_()),
            "read xdt, write y and s (copy_)": lambda: (
                y0.copy_(x), s0.copy_(x[:, :, :hd, :n])),
        }
        for name, fn in floors.items():
            print(json.dumps({"kernel": "ssd_chunk", "variant": name,
                              "shape": list(shape),
                              "device_ms": events_ms(fn)}), flush=True)
        for name, so in libs.items():
            fn = ctypes.CDLL(so).ssd_chunk_fwd
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + \
                [ctypes.c_int] * 4 + [ctypes.c_void_p]
            y = torch.empty_like(x)
            s = torch.empty(g, h, hd, n, device="cuda")
            args = [ctypes.c_void_p(t.data_ptr())
                    for t in (c, b, x, cum, y, s)] + [g, h, lc, n, hd, stream]
            if fn(*args) != 0:
                raise SystemExit(f"launch of '{name}' failed")
            torch.cuda.synchronize()
            rec = {"kernel": "ssd_chunk", "variant": name, "shape": list(shape),
                   "device_ms": events_ms(lambda: fn(*args))}
            if name == "kernel":
                rec["bitwise"] = bool(torch.equal(y, ry) and torch.equal(s, rs))
                rec["max_abs_err"] = max(float((y - ry).abs().max()),
                                         float((s - rs).abs().max()))
            print(json.dumps(rec), flush=True)


def flash_routes(gen, stream):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref
    lib = K._lib()
    for b, s, h, dh, causal in ((32, 64, 24, 128, False),
                                (32, 64, 32, 80, True)):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
                       .to(dt) for _ in range(3))
            o = torch.empty_like(q)
            args = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o)] + \
                [b, s, s, h, h, dh, dh ** -0.5, int(causal),
                 K.DTYPE_CODES[dt], stream]
            ms = events_ms(lambda: lib.flash_attention_fwd(*args))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = events_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            err = float((o.float() - attention_ref(q, k, v, causal).float())
                        .abs().max())
            print(json.dumps({"kernel": "flash_attention",
                              "shape": [b, s, h, dh], "causal": causal,
                              "dtype": str(dt).replace("torch.", ""),
                              "device_ms": ms, "sdpa_ms": sdpa,
                              "max_abs_err": err}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = _build(_variants())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ablate_ssd(libs, gen, stream)
    flash_routes(gen, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
