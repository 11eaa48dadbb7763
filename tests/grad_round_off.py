"""The f32 round-off of the training gradient, measured: the port's f32
gradient and the reference's f32 gradient, each against the port's float64
gradient, on the inputs of
``tests/test_torch_scenarios.py::test_training_loss_and_gradient_match_reference``
(reduced at d_model 64, batch 2 x seq 16, params bridged from the
reference's).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/grad_round_off.py

Prints, per arch, max |g - g64| over max |g64| for both f32 gradients and
their distance from each other.  The float64 run is a child process that
maps every ``torch.float32`` in the port to ``torch.float64`` before the
port is imported (the model names f32 explicitly for its norms, softmax and
loss).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

ARCHS = ("stablelm-1.6b", "recurrentgemma-9b")


def _port_grad(arch: str, params_npz: str, out_npy: str, f64: bool) -> None:
    import torch

    if f64:
        torch.float32 = torch.float64
        torch.set_default_dtype(torch.float64)
    torch.set_num_threads(2)
    from repro_torch import bridge
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.models import model as TM
    from repro_torch.optim import transform as T
    from repro_torch.training import param_template

    cfg = reduced(get_config(arch), d_model=64)
    flat, _ = bridge.params_from_jax(dict(np.load(params_npz)), cfg)
    leaf = flat.clone().requires_grad_(True)
    loss, _ = TM.loss_fn(T.flat_view(leaf, param_template(cfg)),
                         make_batch_for(cfg, batch=2, seq=16, seed=0), cfg)
    (g,) = torch.autograd.grad(loss, leaf)
    np.save(out_npy, g.double().numpy())


def main() -> None:
    import jax
    from jax.flatten_util import ravel_pytree

    from repro.checkpoint.store import _flatten_with_keys
    from repro.configs import get_config, reduced
    from repro.data import make_batch_for
    from repro.models import model as JM
    from repro.training import init_params

    with tempfile.TemporaryDirectory() as tmp:
        for arch in ARCHS:
            cfg = reduced(get_config(arch), d_model=64)
            params = init_params(jax.random.PRNGKey(0), cfg)
            keys, leaves, _ = _flatten_with_keys(params)
            npz = os.path.join(tmp, "params.npz")
            np.savez(npz, **{k: np.asarray(v) for k, v in zip(keys, leaves)})
            batch = make_batch_for(cfg, batch=2, seq=16, seed=0)
            _, jg = jax.value_and_grad(lambda p: JM.loss_fn(p, batch, cfg), has_aux=True)(params)
            ref = np.asarray(ravel_pytree(jg)[0]).astype(np.float64)
            grads = {}
            for name, f64 in (("port32", False), ("port64", True)):
                out = os.path.join(tmp, name + ".npy")
                subprocess.run([sys.executable, __file__, "--child", arch, npz, out, str(int(f64))],
                               check=True)
                grads[name] = np.load(out)
            g64 = grads["port64"]
            m = np.abs(g64).max()

            def rel(a, b):
                return np.abs(a - b).max() / m

            print(f"{arch}: {g64.size} elements, max|g| {m:.6g}; "
                  f"|port32 - port64| {rel(grads['port32'], g64):.3e}, "
                  f"|ref32 - port64| {rel(ref, g64):.3e}, "
                  f"|port32 - ref32| {rel(grads['port32'], ref):.3e} (each / max|g|)")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        _port_grad(sys.argv[2], sys.argv[3], sys.argv[4], bool(int(sys.argv[5])))
    else:
        main()
