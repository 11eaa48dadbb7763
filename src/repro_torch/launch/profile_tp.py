"""Where a tensor-parallel serve's time goes on one card: the all-reduces
against the rest.

    PYTHONPATH=src python -m repro_torch.launch.profile_tp \\
        [--arch qwen2-moe-a2.7b] [--layers 4] [--model 2] [--batch 4] \\
        [--prompt_len 512] [--steps 8]

Spawns ``--model`` gloo ranks on the one card (data 1 x model n, the layout
of ``chip_smoke.py``'s phases 13 to 15), each holding its blocks of the
arch at full width, in f32, on the kernels (flash, and the RG-LRU and
selective-scan kernels on the rank's channels), at ``--layers`` depth (0:
the config's; whisper's encoder is cut to the same depth).  Any of the ten
archs: the Mamba layer's all-reduces count as ``ssm_proj`` / ``ssm_out``,
the RG-LRU's as ``lru_gather`` / ``lru_out``.  Each rank serves once
untimed, then serves twice:

* as served: prefill seconds and decode ms a step (the launcher's clocks);
* with every all-reduce timed alone: the device synchronized before it,
  the host's wall time of the gloo all-reduce (its copies between card and
  host included) summed by purpose
  (:data:`repro_torch.sharding.collectives.COLLECTIVE_BYTES`' keys), with
  the count and the bytes.  The rest of the pass is the other work.

Each rank writes its JSON record to a file of its own; once all have ended,
the parent prints them one line each, in rank order.  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import tempfile
import time


def _rank(rank, args, tmp):
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.training import init_params

    store = os.path.join(tmp, "store")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=args.model, timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh((1, args.model), ("data", "model"), device="cuda")
    torch.cuda.set_device(mesh.device)
    cfg = get_config(args.arch)
    depth = {"num_layers": args.layers or cfg.num_layers}
    if cfg.is_encoder_decoder:
        depth["num_encoder_layers"] = args.layers or cfg.num_encoder_layers
    cfg = dataclasses.replace(cfg, **depth, activation_dtype="float32", use_pallas=True)
    with torch.no_grad(), use_sharding_rules(mesh):
        params = init_params(0, cfg, mesh.device)
        torch.cuda.empty_cache()
        batch = make_batch_for(cfg, batch=args.batch, seq=args.prompt_len, seed=0,
                               device=mesh.device)
        serve(cfg, params, batch, gen=1)
        dist.barrier()
        res = serve(cfg, params, batch, gen=args.steps)

        secs, counts, nbytes = {}, {}, {}
        inner = C._all_reduce

        def timed(t, group, what, op=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(t, group, what, op)
            torch.cuda.synchronize()
            secs[what] = secs.get(what, 0.0) + time.perf_counter() - t0
            counts[what] = counts.get(what, 0) + 1
            nbytes[what] = nbytes.get(what, 0) + t.numel() * t.element_size()
            return out

        C._all_reduce = timed
        try:
            dist.barrier()
            t0 = time.perf_counter()
            serve(cfg, params, batch, gen=args.steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            C._all_reduce = inner
    total = sum(secs.values())
    with open(os.path.join(tmp, f"rank_{rank}.json"), "w") as f:
        json.dump({
            "arch": args.arch, "layers": cfg.num_layers, "rank": rank, "model": args.model,
            "batch": args.batch, "prompt_len": args.prompt_len, "steps": args.steps,
            "prefill_s": res["prefill_s"],
            "decode_ms_per_step": res["decode_s"] / args.steps * 1e3,
            "timed_pass_s": wall, "all_reduce_s": total, "other_s": wall - total,
            "all_reduce_s_by_purpose": secs, "all_reduce_count_by_purpose": counts,
            "all_reduce_bytes_by_purpose": nbytes,
            "card": torch.cuda.get_device_name(mesh.device)}, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--layers", type=int, default=4, help="depth (0: the config's)")
    ap.add_argument("--model", type=int, default=2, help="ranks over `model`")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        raise SystemExit("profile_tp needs a CUDA device")
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="profile_tp_") as tmp:
        mp.spawn(_rank, args=(args, tmp), nprocs=args.model, join=True)
        for rank in range(args.model):
            with open(os.path.join(tmp, f"rank_{rank}.json")) as f:
                print(json.dumps(json.load(f)), flush=True)


if __name__ == "__main__":
    main()
