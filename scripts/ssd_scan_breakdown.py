"""The bf16 tensor-core scan at state 64 (zamba2-2.7b's SSM shape) taken
apart on one H100:

    python3 scripts/ssd_scan_breakdown.py      # from the repository root

1. The forward (``csrc/ssd_scan.cu``) as built, with its ring of two
   stages, against a copy compiled with three at state 64
   (``TcLayout::kStages``; three do not fit at 128), on
   the same inputs at (B, 4608, 80 heads of 64, state 64, chunk 128), B = 4
   and 1: device ms a call from replayed CUDA graphs, in turns (two,
   three, three, two), and whether the two give the same bits.
2. The backward's four kernels (``csrc/ssd_scan_bwd_wgmma.cu``) and the
   forward, device ms a call by kernel from ``torch.profiler``, at zamba2's
   shape and at Mamba-2's (32 heads, state 128).

Prints the results as one JSON object on its last line and writes it to
``build/ssd_scan_breakdown/breakdown.json``, beside the three-stage copy
and its library.  Needs a card and ``nvcc``."""
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ssd_scan as sm  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("ssd_scan_breakdown: no CUDA device")
WORK = "build/ssd_scan_breakdown"
CSRC = "src/repro_torch/kernels/csrc"

dev = torch.device("cuda")
out = {"card": cs.card_line()}
with open(f"{CSRC}/ssd_scan.cu") as fh:
    src = fh.read()
old = "static constexpr int kStages = 2;"
if old not in src:
    sys.exit(f"ssd_scan_breakdown: {CSRC}/ssd_scan.cu no longer names "
             f"{old!r}")
os.makedirs(WORK, exist_ok=True)
for f in os.listdir(CSRC):
    if f.endswith(".cuh"):
        with open(f"{CSRC}/{f}") as fh, open(f"{WORK}/{f}", "w") as out_fh:
            out_fh.write(fh.read())
with open(f"{WORK}/ssd_scan3.cu", "w") as fh:
    # three stages fit at state 64 only (3 x 80 KB do not at 128)
    fh.write(src.replace(old,
                         "static constexpr int kStages = N == 64 ? 3 : 2;"))
r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    f"{WORK}/ssd_scan3.so", f"{WORK}/ssd_scan3.cu"],
                   capture_output=True, text=True)
if r.returncode:
    sys.exit(f"nvcc failed:\n{r.stdout}{r.stderr}")
lib3 = ctypes.CDLL(f"{WORK}/ssd_scan3.so").ssd_scan_wgmma_fwd
lib3.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
lib3.restype = ctypes.c_int
g = torch.Generator(device=dev).manual_seed(3)
L, P, Q = 4608, 64, 128


def inputs(B, H, N):
    x, dt, a, bm, cm = cs._ssd_inputs(g, dev, B, L, H, P, N, "mamba2",
                                      torch.bfloat16)
    x, bm, cm = cs._ssd_conv_slices(x, bm, cm)
    return x, dt, a, bm, cm


for (B, H, N) in ((4, 80, 64), (1, 80, 64)):
    x, dt, a, bm, cm = inputs(B, H, N)

    def two():
        return sm.ssd_scan(x, dt, a, bm, cm, chunk=Q)

    def three():
        y = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
        hT = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
        rc = lib3(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                  cm.data_ptr(), y.data_ptr(), hT.data_ptr(), B, L, H, N,
                  x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
                  cm.stride(0), cm.stride(1),
                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ssd_scan_wgmma_fwd (three stages): CUDA "
                               f"error {rc}")
        return y, hT

    y2, h2 = two()
    y3, h3 = three()
    torch.cuda.synchronize()
    same = bool(torch.equal(y2, y3) and torch.equal(h2, h3))
    ts = [cs.graph_ms(f, 5) for f in (two, three, three, two)]
    key = f"fwd B={B} H={H} N={N}"
    out[key] = {"two_stages_ms": [ts[0], ts[3]],
                "three_stages_ms": [ts[1], ts[2]], "bitwise_equal": same}
    print(key, out[key], flush=True)
# the backward's kernels, one by one, at both widths
for (B, H, N) in ((4, 80, 64), (4, 32, 128)):
    x, dt, a, bm, cm = inputs(B, H, N)
    dy = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    for _ in range(3):
        sm.ssd_scan_bwd(x, dt, a, bm, cm, dy, None, chunk=Q)
        sm.ssd_scan(x, dt, a, bm, cm, chunk=Q)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            sm.ssd_scan_bwd(x, dt, a, bm, cm, dy, None, chunk=Q)
            sm.ssd_scan(x, dt, a, bm, cm, chunk=Q)
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        t = (getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0))
        if t and e.count:
            rows[e.key[:90]] = t / 10 / 1000   # us over 10 calls, in ms
    out[f"kernels B={B} H={H} N={N} (ms a call)"] = rows
    print(json.dumps(rows, indent=1), flush=True)
with open(f"{WORK}/breakdown.json", "w") as fh:
    json.dump(out, fh, indent=1)
print(json.dumps(out))
