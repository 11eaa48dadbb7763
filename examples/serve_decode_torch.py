"""Batched serving over the PyTorch/CUDA port (``repro_torch``): the
counterpart of ``examples/serve_decode.py``.  Prefill a prompt batch, then
greedy-decode with the per-layer-type KV/state caches (full, ring, SSM,
RG-LRU).

Uses the reduced recurrentgemma config by default: the hybrid cache is the
interesting one (RG-LRU state + conv ring + local-attention ring cache).  On
the card the prefill runs the hand-written kernels (``use_pallas=True``:
flash attention and the RG-LRU scan).

    PYTHONPATH=src python examples/serve_decode_torch.py --arch recurrentgemma-9b
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

Ends with ``check: ... ids in [0, vocab): ok`` (or ``FAILED``, exit code 1).
"""

import argparse
import dataclasses
import sys

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.launch.serve import serve
from repro_torch.training import init_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="recurrentgemma-9b", choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    device = torch.device(args.device)
    if device.type == "cuda":
        cfg = dataclasses.replace(cfg, use_pallas=True)
    params = init_params(0, cfg, device)
    batch = make_batch_for(cfg, batch=args.batch, seq=args.prompt_len, seed=0, device=device)
    res = serve(cfg, params, batch, gen=args.gen)
    print(f"[{cfg.name}] prefill {args.prompt_len} tokens x {args.batch}: "
          f"{res['prefill_s']:.2f}s")
    print(f"decode {args.gen} steps: {res['decode_s']:.2f}s  "
          f"({res['tok_per_s']:.1f} tok/s)")
    ids = res["tokens"].cpu()
    print("sample token ids:", ids[0, :12].tolist())
    ok = tuple(ids.shape) == (args.batch, args.gen) and bool(
        ((ids >= 0) & (ids < cfg.vocab_size)).all())
    print(f"check: {tuple(ids.shape)} ids in [0, {cfg.vocab_size}): {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
