#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root

Builds the Hopper kernels of ``src/repro_torch/kernels/csrc`` with nvcc
into ``build/``, then runs:

1. kernel parity — each kernel against its plain PyTorch version on the
   card (``fft4step`` at N in {16, 64, 256, 1024, 4096} x sign +-1 within
   3e-4 * max|ref|; ``rotate_blocks`` at the ring shapes of phase 3,
   bitwise), each timed with CUDA events beside its plain version, one
   library call computing the same function, and its bound;
2. the main path on one rank at full size: ``Croft3D`` forward and
   inverse of the croft-1024 grid (1024^3 complex64, an 8 GiB field)
   with ``local_impl="pallas"``, checked against ``torch.fft.fftn``
   (5e-4 * max|ref|) and by its round trip (< 1e-4);
3. the distributed executor: 4 ranks on the one card, joined by a gloo
   process group, pencil 2x2 and slab 4 at 256^3, every transpose impl x
   K in {1, 2} x overlap mode x output layout, each rank's block checked
   against its slice of ``torch.fft.fftn``, the impls bitwise equal;
4. one JSON line on the kernels, the card's name and power limit, and
   the result line.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
FULL = 1024            # croft-1024, src/repro/configs/croft_fft.py
DIST = 256             # phase-3 grid: 4 ranks share one card's memory and wire
RANKS = 4
FFT_TOL = 3e-4         # tests/test_kernels_fft.py:18
FFT3_TOL = 5e-4        # tests/test_kernels_fft.py:78
RT_TOL = 1e-4          # tests/test_distributed_fft.py:28
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_S = 67e12    # H100 SXM FP32 outside the tensor cores
TIMEOUT_S = 900


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_abs_diff(a, b, step: int = 64) -> float:
    """max |a - b| slab by slab along dim 0 (bounded temporaries)."""
    return max((a[i:i + step] - b[i:i + step]).abs().max().item()
               for i in range(0, a.shape[0], step))


def max_abs(a, step: int = 64) -> float:
    return max(a[i:i + step].abs().max().item()
               for i in range(0, a.shape[0], step))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


# ---------------------------------------------------------------------------
# phase 1: kernel parity and timing
# ---------------------------------------------------------------------------

def phase_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import fft_matmul, transpose_pack
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    worst = 0.0
    for n in (16, 64, 256, 1024, 4096):
        rows = min(1 << 20, (1 << 30) // n)     # at most an 8 GiB batch
        x = torch.randn(rows, n, dtype=torch.complex64, device=dev,
                        generator=gen)
        for sign in (-1, 1):
            y = fft_matmul.fft4step(x, sign)
            ref = fft_matmul.fft4step_plain(x, sign)
            torch.cuda.synchronize()
            err = max_abs_diff(y, ref, 1 << 14)
            tol = FFT_TOL * max_abs(ref, 1 << 14)
            print(f"[1] fft4step N={n} rows={rows} sign={sign:+d} "
                  f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
            check(err <= tol, f"fft4step N={n} sign={sign}")
            if n == FULL:
                worst = max(worst, err)
            del y, ref
        if n == FULL:
            # the main path's shape: one axis of the 1024^3 grid
            k_ms = time_ms(lambda: fft_matmul.fft4step(x, -1))
            p_ms = time_ms(lambda: fft_matmul.fft4step_plain(x, -1))
            l_ms = time_ms(lambda: torch.fft.fft(x))
            nbytes = 2 * x.numel() * 8 + 3 * n * 8
            b_ms, b_by = bound_ms(nbytes, 5.0 * n * math.log2(n) * rows)
            out["fft4step"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   shape=[rows, n])
        if n == DIST:
            # phase 3's shape: one rank's 256^3/4 block, one axis
            xs = x[:DIST * DIST // 4]
            b_ms, b_by = bound_ms(2 * xs.numel() * 8 + 3 * n * 8,
                                  5.0 * n * math.log2(n) * xs.shape[0])
            print(f"[1] fft4step at {tuple(xs.shape)}: ms="
                  f"{time_ms(lambda: fft_matmul.fft4step(xs, -1), reps=50)} "
                  f"plain_ms="
                  f"{time_ms(lambda: fft_matmul.fft4step_plain(xs, -1))} "
                  f"library_ms={time_ms(lambda: torch.fft.fft(xs), reps=50)} "
                  f"bound_ms={b_ms} bound_by={b_by}", flush=True)
        del x
        torch.cuda.empty_cache()
    out["fft4step"]["max_abs_err"] = worst
    print(f"[1] fft4step at ({1 << 20}, {FULL}): {out['fft4step']}", flush=True)

    # rotate_blocks at the ring shapes of phase 3 (one rank's 256^3/4 block)
    d, q = DIST, DIST // 2
    cases = [((d, q, q), 0, 2), ((q, d, q), 1, 2), ((q, q, d), 2, 2),
             ((d, d, d // 4), 0, 4), ((d // 4, d, d), 2, 4)]
    for shape, axis, p in cases:
        x = torch.randn(*shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        for idx in range(p):
            pieces = transpose_pack.pack_pieces(x, axis, idx, p)
            plain = transpose_pack.rotate_block_rows_plain(
                x, math.prod(shape[:axis]), p, x.numel() // p
                // math.prod(shape[:axis]), idx, dst_piece_major=True)
            check(torch.equal(torch.stack(pieces).reshape(-1), plain),
                  f"pack {shape} axis={axis} idx={idx}")
            buf = torch.stack(pieces)
            back = transpose_pack.unpack_pieces(buf, axis, -idx)
            unit = buf[0].numel() // math.prod(shape[:axis])
            plain = transpose_pack.rotate_block_rows_plain(
                buf, math.prod(shape[:axis]), p, unit, -idx,
                src_piece_major=True)
            check(torch.equal(back.reshape(-1), plain) and torch.equal(back, x),
                  f"unpack {shape} axis={axis} idx={idx}")
        print(f"[1] rotate_blocks {shape} axis={axis} P={p}: bitwise equal",
              flush=True)
    x = torch.randn(q, d, q, dtype=torch.complex64, device=dev, generator=gen)
    rot = lambda: transpose_pack.rotate_blocks(x, 1, 1, 2)
    plain = lambda: transpose_pack.rotate_block_rows_plain(x, q, 2, q * q, 1)
    check(torch.equal(rot(), torch.roll(x, -q, dims=1)), "rotate vs roll")
    b_ms, b_by = bound_ms(2 * x.numel() * 8, 0.0)
    out["rotate_blocks"] = dict(
        ms=time_ms(rot, reps=50), plain_ms=time_ms(plain, reps=50),
        library_ms=time_ms(lambda: torch.roll(x, -q, dims=1), reps=50),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0, shape=[q, d, q])
    print(f"[1] rotate_blocks at ({q}, {d}, {q}) axis 1: "
          f"{out['rotate_blocks']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 2: the main path on one rank, full size
# ---------------------------------------------------------------------------

def phase_full(dev) -> dict:
    import torch
    from repro_torch.core import Croft3D, FFTOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (FULL,) * 3
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    plan = Croft3D(shape, opts=FFTOptions(local_impl="pallas"))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    y = plan.forward(x)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    ref = torch.fft.fftn(x)        # oracle only
    err = max_abs_diff(y, ref) / max_abs(ref)
    del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xb = plan.inverse(y)
    torch.cuda.synchronize()
    t_inv = time.perf_counter() - t0
    counts = launch_counts()
    rt = max_abs_diff(xb, x)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[2] Croft3D {shape} pallas: forward {t_fwd * 1e3:.2f} ms, "
          f"inverse {t_inv * 1e3:.2f} ms, rel err vs fftn {err:.3e}, "
          f"round trip {rt:.3e}, launches {counts}, peak {peak:.1f} GiB",
          flush=True)
    check(err < FFT3_TOL, f"1024^3 forward rel err {err}")
    check(rt < RT_TOL, f"1024^3 round trip {rt}")
    check(counts.get("fft4step", 0) > 0, "fft4step not launched")
    del y, xb
    torch.cuda.empty_cache()
    # where one forward's device time goes, by kernel (the launches made
    # here are outside the counted run above)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        plan.forward(x)
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3
    print(f"[2] profiled forward: device busy {busy:.2f} ms", flush=True)
    for e in rows[:6]:
        print(f"[2]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<3d} "
              f"{e.key[:90]}", flush=True)
    del x
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 3: the distributed executor, 4 ranks on one card
# ---------------------------------------------------------------------------

def worker(rank: int, port: int) -> None:
    """One rank of phase 3; prints its result as one JSON line."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import (Croft3D, Decomposition, FFTOptions,
                                  make_mesh)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=RANKS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (DIST,) * 3
    x = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
    ref = torch.fft.fftn(x)        # oracle only
    scale = ref.abs().max().item()
    res = {"rank": rank, "err": 0.0, "rt": 0.0, "fwd_ms": {},
           "fwd_launches": {}, "host_staged_bytes": 0}
    reset_launch_counts()
    for sizes, names, dec in (
            ((2, 2), ("data", "model"), Decomposition("pencil",
                                                      ("data", "model"))),
            ((4,), ("p",), Decomposition("slab", ("p",)))):
        mesh = make_mesh(sizes, names, device=dev)
        for layout in ("natural", "spectral"):
            base = None
            for impl in ("alltoall", "ring", "pairwise"):
                for k in (1, 2):
                    for mode in ("pipelined", "unrolled"):
                        opts = FFTOptions(overlap_k=k, transpose_impl=impl,
                                          overlap_mode=mode,
                                          output_layout=layout,
                                          local_impl="pallas")
                        plan = Croft3D(shape, mesh, dec, opts)
                        xl = x[plan.input_sharding].contiguous()
                        torch.cuda.synchronize()
                        before = launch_counts()
                        t0 = time.perf_counter()
                        y = plan.forward(xl)
                        torch.cuda.synchronize()
                        t = (time.perf_counter() - t0) * 1e3
                        after = launch_counts()
                        xb = plan.inverse(y)
                        tag = f"{dec.kind}/{layout}/{impl}/k{k}/{mode}"
                        res["fwd_launches"][tag] = {
                            n: after.get(n, 0) - before.get(n, 0)
                            for n in after}
                        err = (y - ref[plan.output_sharding]).abs().max().item()
                        rt = (xb - xl).abs().max().item()
                        if err >= FFT3_TOL * scale or rt >= RT_TOL:
                            raise SystemExit(f"rank {rank} {tag}: err "
                                             f"{err / scale} rt {rt}")
                        if base is None:
                            base = y
                        elif not torch.equal(y, base):
                            raise SystemExit(f"rank {rank} {tag}: differs "
                                             "bitwise from the first config")
                        res["err"] = max(res["err"], err / scale)
                        res["rt"] = max(res["rt"], rt)
                        res["fwd_ms"][tag] = t
        res["host_staged_bytes"] += mesh.host_staged_bytes
    res["launches"] = launch_counts()
    dist.destroy_process_group()
    print("RESULT " + json.dumps(res), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_distributed() -> dict:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(RANKS)]
    outs = []
    try:
        deadline = time.time() + TIMEOUT_S
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(out[-4000:], file=sys.stderr)
            raise SystemExit(f"FAILED: phase 3 rank {r} exited "
                             f"{p.returncode}")
        results.append(json.loads(lines[-1][len("RESULT "):]))
    counts = {}
    for res in results:
        for name, c in res["launches"].items():
            counts[name] = counts.get(name, 0) + c
    fwd = {}
    for tag in results[0]["fwd_ms"]:
        fwd[tag] = max(res["fwd_ms"][tag] for res in results)
    for tag, t in fwd.items():
        print(f"[3] {tag}: forward {t:.1f} ms (slowest rank, host clock, "
              f"gloo), launches per rank {results[0]['fwd_launches'][tag]}",
              flush=True)
    summary = dict(
        err=max(r["err"] for r in results), rt=max(r["rt"] for r in results),
        launches=counts,
        host_staged_bytes=sum(r["host_staged_bytes"] for r in results))
    print(f"[3] 4 ranks, {DIST}^3: {summary}", flush=True)
    check(counts.get("fft4step", 0) > 0, "fft4step not launched in phase 3")
    check(counts.get("rotate_blocks", 0) > 0,
          "rotate_blocks not launched in phase 3")
    return counts


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    t0 = time.time()
    for name, log in _build.build_all().items():
        usage = [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l]
        print(f"[0] built {name}: " + " | ".join(usage), flush=True)
    print(f"[0] build {time.time() - t0:.1f} s", flush=True)

    timings = phase_kernels(dev)
    full = phase_full(dev)
    dist_counts = phase_distributed()

    replaces = {"fft4step": "src/repro/kernels/fft_matmul.py:107",
                "rotate_blocks": "src/repro/kernels/transpose_pack.py:84"}
    kernels = []
    for name in ("fft4step", "rotate_blocks"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": full.get(name, 0) + dist_counts.get(name, 0),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
