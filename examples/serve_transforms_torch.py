"""Transform-service quickstart on the PyTorch port: heterogeneous
spectral transforms from three concurrent clients through one shared,
plan-cached, continuously batched service.

    PYTHONPATH=src python examples/serve_transforms_torch.py          # the card
    PYTHONPATH=src python examples/serve_transforms_torch.py --device cpu

The port of ``examples/serve_transforms.py``.  Three client "apps" share
the service — a c2c solver (forward, then inverse), an r2c analysis
pass (real field to half spectrum and back) and a filtered
(Poisson-style) solve whose k-space multiply rides inside the forward.
Requests that land in the same dispatch window and share a plan and a
transform are stacked into one batch (``Croft3D.forward_batched``).
Each client checks its results against ``numpy.fft``; the script prints
"OK" when every error is below 1e-3.
"""

import argparse
import threading

import numpy as np

from repro_torch.serve import TransformService

N = 16


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client app")
    args = ap.parse_args()

    errs = []

    def solver(svc, rng):
        """c2c round trip: forward, then inverse of the spectrum."""
        x = (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)
             ).astype(np.complex64)
        for _ in range(args.requests):
            y = svc.transform(x, problem="c2c")
            x_back = svc.transform(y, problem="c2c", direction="inverse")
            errs.append(("c2c vs numpy", float(np.max(np.abs(
                y - np.fft.fftn(x))) / np.max(np.abs(y)))))
            errs.append(("c2c roundtrip", float(np.max(np.abs(x_back - x)))))

    def analysis(svc, rng):
        """r2c half spectrum of a real field (the inverse needs shape=)."""
        x = rng.randn(N, N, N).astype(np.float32)
        for _ in range(args.requests):
            y = svc.transform(x, problem="r2c")
            x_back = svc.transform(y, problem="r2c", direction="inverse",
                                   shape=(N, N, N))
            errs.append(("r2c vs numpy", float(np.max(np.abs(
                y - np.fft.rfftn(x))) / np.max(np.abs(y)))))
            errs.append(("r2c roundtrip", float(np.max(np.abs(x_back - x)))))

    def filtered(svc, rng):
        """The fused forward + filter epilogue: FFT(x) * h in one call."""
        x = (rng.randn(N, N, N) + 1j * rng.randn(N, N, N)
             ).astype(np.complex64)
        h = np.exp(-0.1 * np.arange(N * N * N).reshape(N, N, N)
                   ).astype(np.complex64)
        for _ in range(args.requests):
            y = svc.transform(x, problem="filtered", h=h)
            ref = svc.transform(x, problem="c2c") * h
            errs.append(("filtered vs c2c*h",
                         float(np.max(np.abs(y - ref)))))

    with TransformService(device=args.device, max_batch=4,
                          max_wait_ms=2.0) as svc:
        threads = [threading.Thread(target=fn,
                                    args=(svc, np.random.RandomState(i)))
                   for i, fn in enumerate((solver, analysis, filtered))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = svc.stats()

    worst = {}
    for name, err in errs:
        worst[name] = max(worst.get(name, 0.0), err)
    print(f"device: {svc.device}")
    for name, err in sorted(worst.items()):
        print(f"{name:20s} max|err| = {err:.3e}")
    print(f"\nserved {stats['requests']} requests in {stats['batches']} "
          f"batches (mean batch {stats['mean_batch']:.2f}, occupancy "
          f"{stats['occupancy']:.0%})")
    print(f"plan cache: {stats['plan_cache']['stats']}")
    if len(worst) != 5 or not all(e < 1e-3 for e in worst.values()):
        raise SystemExit(f"FAILED: {worst}")
    print("OK")


if __name__ == "__main__":
    main()
