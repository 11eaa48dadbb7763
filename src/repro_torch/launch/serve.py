"""Serving launcher of the port (the counterpart of ``repro.launch.serve``):
prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
        --batch 4 --prompt_len 4096 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --batch 4 --prompt_len 4096 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --batch 4 --prompt_len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Any of the ten archs (``--arch``).  Runs on the card by default, and there
with ``use_pallas=True``: the self-attention of every local or global layer
(and of whisper's encoder) runs the hand-written flash kernel, every RG-LRU
layer the hand-written RG-LRU kernel and every Mamba layer the hand-written
selective-scan kernel, the counterpart of the reference's TPU fast path.
Decode runs none of them: its step is plain PyTorch, as the reference's is
plain jnp.  ``--device cpu`` keeps the config's value (the
plain PyTorch path).  Params are random, drawn from ``--seed``; the decode
cache is f32, as the reference launcher's.  Prints the prefill and decode
times, tok/s and the ids generated for the first prompt; ``--json PATH``
also writes them as the reference's three bench.v1 rows
(:mod:`repro_torch.bench_schema`).

A vlm prompt is its ``num_prefix_embeddings`` vision embeddings and its
tokens: the cache holds ``P + S + gen`` positions and decoding starts at
``P + S``.  (The reference launcher sizes the cache ``S + gen`` and starts at
``S``, which trips its prefill's capacity check for ``gen < P`` and
otherwise decodes over the prompt's slots; the port does not copy that.)
Whisper follows the reference launcher: no decoder prefill, a cache whose
cross-attention K/V come from encoding ``enc_embeds``, and greedy steps from
position 0 starting with the first prompt token.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.models import model as M
from repro_torch.sharding import collectives as C
from repro_torch.training import init_params, make_serve_step


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, batch: dict, *, gen: int, cache_dtype=torch.float32) -> dict:
    """Prefill ``batch["tokens"]`` (B, S), then ``gen`` batched greedy steps.

    Returns the prefill's last logits (B, V; None for whisper, which has no
    decoder prefill), the decode steps' logits (B, gen, V), the generated ids
    (B, gen) and the host-clock times of the prefill (for whisper: the
    encoder and the cross K/V) and the decode (each ending in a device
    synchronize).

    Under ``use_sharding_rules`` with a running sharded mesh, ``params`` are
    the rank's blocks (:func:`repro_torch.training.init_params` under the
    same rules: over ``data`` too in the FSDP storage, gathered a layer at a
    time in the prefill and in every decode step; whole over ``data`` under
    ``replicate_params_over_data``), the rank serves its rows of ``batch``
    (all of them at data 1), its caches hold its kv heads (whisper: of the self- and the cross
    K/V) and its channels of every Mamba and RG-LRU layer's conv window and
    state, the logits are its vocab block (``V / model``; whole on every
    rank where ``model`` does not divide the vocab, as internvl2-2b's) and
    the greedy ids are the global ones, the same on every model rank.

    Under ``SPEC_OPTIONS["seq_shard_cache"]`` (the reference's flash-decode
    layout; :func:`repro_torch.sharding.specs.capacity_split`) a rank's
    attention caches may hold its block of the capacity instead: where a
    layer's kv heads do not split over ``model``, every kv head and
    ``C / model`` of the slots (a decode step gathers the query heads over
    ``model``); else for a batch of one row at data > 1, its kv heads and
    ``C / data`` of the slots (whisper's self and cross K/V alike), each
    only where the axes divide C.  A decode step writes each token on the
    rank that holds its slot, and every rank's partial softmax is combined
    over those axes (``kv_gather`` / ``kv_combine`` in the byte counter).
    The serve runs inside :func:`repro_torch.sharding.collectives.serving`
    (the global batch, the capacity and the encoder frames), which the
    layout reads.
    """
    B_all, S = batch["tokens"].shape
    if cfg.is_encoder_decoder:  # steps from position 0, a cache of S + gen
        start, frames = 0, batch["enc_embeds"].shape[1]
        capacity = S + gen
    else:
        pre = batch.get("prefix_embeds") if cfg.frontend == "vision" else None
        start, frames = S + (0 if pre is None else pre.shape[1]), None
        capacity = start + gen
    with C.serving(B_all, capacity, frames):
        return _serve(cfg, params, batch, gen=gen, start=start, capacity=capacity,
                      cache_dtype=cache_dtype)


def _serve(cfg, params, batch: dict, *, gen: int, start: int, capacity: int,
           cache_dtype) -> dict:
    mesh = C.sharded_mesh()
    if mesh is not None:
        batch = C.local_rows(batch, mesh, strict=False)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    if cfg.is_encoder_decoder:
        prefill_logits = None
        cache = M.init_decode_state(params, cfg, B, capacity, cache_dtype=cache_dtype,
                                    batch=batch)
        last = tokens[:, 0].to(torch.int32)
    else:
        prefill_logits, cache = M.prefill(params, batch, cfg, capacity, cache_dtype=cache_dtype)
        last = C.greedy_argmax(prefill_logits, C.vocab_mesh(cfg)).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    step = make_serve_step(cfg)
    start = torch.tensor(start, device=dev)  # positions stay on the device: no sync per step
    ids, logits = [], []
    t0 = time.perf_counter()
    for i in range(gen):
        out = step(params, cache, last, start + i)
        last, cache = out["next_token"], out["cache"]
        ids.append(last)
        logits.append(out["logits"])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "prefill_logits": prefill_logits,
        "logits": torch.stack(logits, dim=1) if logits else None,
        "tokens": torch.stack(ids, dim=1) if ids else None,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": gen * B / t_decode if gen else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", help="small same-family variant")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write timings as bench.v1 rows to PATH")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = torch.device(args.device)
    if device.type == "cuda":
        cfg = dataclasses.replace(cfg, use_pallas=True)
    params = init_params(args.seed, cfg, device)
    batch = make_batch_for(cfg, batch=args.batch, seq=args.prompt_len, seed=args.seed,
                           device=device)
    result = serve(cfg, params, batch, gen=args.gen)
    print(f"arch={cfg.name} layers={cfg.num_layers} device={device} use_pallas={cfg.use_pallas}")
    print(f"prefill: {result['prefill_s']:.2f}s")
    if args.gen:
        print(f"decode: {args.gen} steps x batch {args.batch} in {result['decode_s']:.2f}s "
              f"({result['tok_per_s']:.1f} tok/s)")
        print("generated token ids [0]:", result["tokens"][0].tolist())
    if args.json:
        from repro_torch.bench_schema import bench_row, write_bench_json

        config = {"arch": args.arch, "batch": args.batch, "prompt_len": args.prompt_len,
                  "gen": args.gen, "reduced": args.reduced, "seed": args.seed}
        base = f"serve/{args.arch}"
        write_bench_json(args.json, [
            bench_row(f"{base}/prefill_s", result["prefill_s"], "s", config),
            bench_row(f"{base}/decode_s", result["decode_s"], "s", config),
            bench_row(f"{base}/tok_per_s", result["tok_per_s"] or 0.0, "tok/s", config),
        ])
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
