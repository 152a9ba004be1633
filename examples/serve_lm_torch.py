"""LM serving example on the PyTorch port: the spectral-mixer layer as a
transform service.

    PYTHONPATH=src python examples/serve_lm_torch.py --users 4 --layers 3
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The port of ``examples/serve_lm.py``.  The FNet-style mixer
(``repro_torch.models.spectral``) is ``Re(FFT_seq(FFT_model(x)))``: a
2-D FFT over (seq, d_model).  Embedded as a 3-D c2c of shape (1, S, D)
(the size-1 leading axis transforms to itself), each user's mixing call
becomes one :class:`repro_torch.serve.TransformService` request:
concurrent users land in the same dispatch window, get stacked into one
batched FFT and share a single plan, the same continuous batching an LM
server applies to decode steps, here at the layer level.  The service is
meshless, on the CUDA card unless ``--device`` says otherwise.

Each user's served output is checked against the direct
``spectral_mixer`` call on the same device; the script prints "OK" when
every one is within 1e-2 of the output's scale.

The prefill/decode loop of the LM archs (the decoder models, whisper-base
with its encoder and paligemma-3b with its image prefix) lives on in
``python -m repro_torch.launch.serve --arch whisper-base --smoke`` (on the
card; ``--device cpu`` off it).
"""

import argparse
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.spectral import spectral_mixer
from repro_torch.serve import TransformService


def mixer_via_service(svc: TransformService, x: np.ndarray) -> np.ndarray:
    """One mixer layer for one user, served: x (S, D) real -> (S, D)."""
    spectrum = svc.transform(x[None].astype(np.complex64), problem="c2c")
    return np.real(spectrum[0]).astype(x.dtype)


def serve_users(users: int = 4, layers: int = 3, seq: int = 64,
                dmodel: int = 32, device=None, wisdom=None,
                seed: int = 0) -> dict:
    """Serve ``users`` concurrent users ``layers`` mixer layers each and
    check every output against the direct call; returns the worst
    difference, the output scale and the service's stats."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    prompts = [rng.randn(seq, dmodel).astype(np.float32)
               for _ in range(users)]
    outputs = [None] * users
    errors = []

    def user(i):
        try:
            h = prompts[i]
            for _ in range(layers):
                h = mixer_via_service(svc, h)
            outputs[i] = h
        except BaseException as e:  # reported by the caller's thread
            errors.append(e)

    with TransformService(device=dev, max_batch=users, max_wait_ms=2.0,
                          wisdom_path=wisdom) as svc:
        threads = [threading.Thread(target=user, args=(i,))
                   for i in range(users)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = svc.stats()
    if errors:
        raise errors[0]

    worst = 0.0
    for i in range(users):
        ref = torch.from_numpy(prompts[i][None]).to(dev)
        for _ in range(layers):
            ref = spectral_mixer(ref)
        worst = max(worst, float(np.max(np.abs(
            outputs[i] - ref[0].cpu().numpy()))))
    scale = max(float(np.max(np.abs(o))) for o in outputs)
    return {"worst": worst, "scale": scale, "stats": stats,
            "device": str(svc.device)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=4)
    ap.add_argument("--layers", type=int, default=3,
                    help="stacked mixer layers per user")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dmodel", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--wisdom", default=None)
    args = ap.parse_args()

    got = serve_users(args.users, args.layers, args.seq, args.dmodel,
                      args.device, args.wisdom)
    stats = got["stats"]
    print(f"device: {got['device']}")
    print(f"{args.users} users x {args.layers} mixer layers "
          f"({args.seq}x{args.dmodel}): max|served - direct| = "
          f"{got['worst']:.3e} (output scale {got['scale']:.1f})")
    print(f"served {stats['requests']} requests in {stats['batches']} "
          f"batches (mean batch {stats['mean_batch']:.2f}, occupancy "
          f"{stats['occupancy']:.0%})")
    print(f"plan cache: {stats['plan_cache']['stats']}")
    if not got["worst"] < 1e-2 * max(got["scale"], 1.0):
        raise SystemExit(f"FAILED: served vs direct {got['worst']}")
    print("OK")


if __name__ == "__main__":
    main()
