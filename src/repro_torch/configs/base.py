"""Model configuration system (port of ``src/repro/configs/base.py``).

A verbatim copy of the reference's JAX-free config module: the port keeps its
own so that it imports nothing of the JAX package.  Every architecture is a
:class:`ModelConfig` registered by name; ``--arch <id>`` on the launcher
resolves through :func:`get_config`.  ``reduced()`` derives the CPU-smoke variant (≤2 pattern
periods, d_model ≤ 512, ≤4 experts) of the *same family* for tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

__all__ = ["ModelConfig", "register", "get_config", "list_configs", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # citation (arXiv / model card)

    # trunk ------------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000

    # attention --------------------------------------------------------------
    # layer-type pattern, tiled over the stack (remainder layers unrolled):
    #   "global" full causal, "local" sliding window, "recurrent" RG-LRU,
    #   "ssm" Mamba-1 block.
    block_pattern: tuple[str, ...] = ("global",)
    window_size: int = 4096
    rope_theta: float = 10_000.0
    attn_logit_softcap: float | None = None  # gemma2: 50.0
    final_logit_softcap: float | None = None  # gemma2: 30.0
    query_scale: float | None = None  # default 1/sqrt(head_dim)

    # mlp --------------------------------------------------------------------
    act: str = "silu"  # silu | gelu
    gated_mlp: bool = True

    # block structure ----------------------------------------------------------
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm (whisper/stablelm)
    use_post_norms: bool = False  # gemma2/3 sandwich norms
    use_rope: bool = True  # whisper uses absolute sinusoidal instead
    parallel_residual: bool = False  # stablelm-2: attn & mlp share the residual

    # embeddings -------------------------------------------------------------
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    norm_eps: float = 1e-6

    # moe ----------------------------------------------------------------------
    num_experts: int = 0  # routed experts (0 = dense MLP)
    num_experts_padded: int = 0  # padded so the expert axis shards (0 = auto)
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert_ff: int = 0  # qwen2-moe: 4 shared experts fused into one MLP
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # ssm (mamba-1) ------------------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 = ceil(d_model / 16)

    # hybrid (recurrentgemma / RG-LRU) ------------------------------------------
    lru_width: int = 0  # 0 = d_model

    # encoder-decoder (whisper) --------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_positions: int = 1500  # whisper mel-frame positions (conv stub output)

    # modality frontend stubs ------------------------------------------------
    # "vision": input_specs provides (batch, num_prefix, d_model) patch embeds
    #           merged in front of the token embeddings (InternVL projector stub).
    # "audio":  encoder consumes (batch, enc_seq, d_model) frame embeds
    #           (mel+conv frontend stub).
    frontend: str | None = None
    num_prefix_embeddings: int = 0

    # numerics ----------------------------------------------------------------
    activation_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # runtime knobs (overridable per run) -------------------------------------
    attn_block_q: int = 512
    attn_block_k: int = 512
    remat: bool = True
    scan_layers: bool = True
    use_pallas: bool = False  # TPU fast path; CPU tests force the jnp path
    sequence_parallel: bool = False  # shard the residual seq axis over `model`
    # the reference pins the grads to the param sharding (FSDP RS); the
    # port's grads come out in each weight's storage layout already, so it
    # changes nothing there
    shard_grads: bool = False
    # weights-stationary MoE: shard expert d_ff over `data` as well as experts
    # over `model`; tokens are gathered (tiny at decode) instead of expert
    # weights — kills the per-step expert all-gather.  Decode-oriented.
    moe_weights_stationary: bool = False

    # ------------------------------------------------------------------------
    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def remainder_layers(self) -> tuple[str, ...]:
        rem = self.num_layers - self.num_periods * self.pattern_period
        return self.block_pattern[:rem]

    @property
    def experts_padded(self) -> int:
        return self.num_experts_padded or self.num_experts

    def layer_types(self) -> tuple[str, ...]:
        return self.block_pattern * self.num_periods + self.remainder_layers

    def supports_long_context(self) -> bool:
        """True iff every mixing layer is sub-quadratic (local/ssm/recurrent)."""
        return all(t != "global" for t in self.block_pattern) or self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + trunk), used for 6·N·D."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embedding (tied unembed adds nothing)
        if not self.tie_embeddings:
            n += v * d
        for t in self.layer_types():
            n += 2 * d  # pre norms (attn+mlp scale vectors, approximation)
            if t in ("global", "local"):
                n += d * self.num_heads * self.head_dim  # wq
                n += 2 * d * self.num_kv_heads * self.head_dim  # wk wv
                n += self.num_heads * self.head_dim * d  # wo
            elif t == "ssm":
                di, N, dtr = self.d_inner, self.ssm_state, self.dt_rank
                n += d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * N) + dtr * di + di * N + di + di * d
            elif t == "recurrent":
                w = self.lru_width or d
                n += d * w * 2 + w * self.ssm_conv + 3 * w + w * d  # two in-proj branches, conv, gates/Lambda, out
            if t != "ssm":  # every non-mamba block carries an MLP/MoE
                if self.num_experts:
                    e, fe = self.num_experts, self.d_ff_expert
                    n += d * e  # router
                    n += e * (3 * d * fe if self.gated_mlp else 2 * d * fe)
                    if self.shared_expert_ff:
                        n += 3 * d * self.shared_expert_ff + d  # shared MLP + gate
                else:
                    n += 3 * d * self.d_ff if self.gated_mlp else 2 * d * self.d_ff
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                n += 4 * d * self.num_heads * self.head_dim + (
                    3 * d * self.d_ff if self.gated_mlp else 2 * d * self.d_ff
                ) + 2 * d
            # decoder cross-attention (one per decoder layer)
            n += self.num_layers * (2 * d * self.num_kv_heads * self.head_dim + 2 * d * self.num_heads * self.head_dim)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, fe = self.d_model, self.d_ff_expert
        per_expert = 3 * d * fe if self.gated_mlp else 2 * d * fe
        inactive = (self.num_experts - self.top_k) * per_expert * len(
            [t for t in self.layer_types() if t != "ssm"]
        )
        return self.param_count() - inactive


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, *, d_model: int = 256, periods: int = 2) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests:
    ≤``periods`` pattern periods, ``d_model`` ≤ 512, ≤4 routed experts."""
    num_layers = cfg.pattern_period * periods
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    upd: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=4 * d_model,
        vocab_size=512,
        window_size=min(cfg.window_size, 64),
        attn_block_q=32,
        attn_block_k=32,
        activation_dtype="float32",
        scan_layers=cfg.scan_layers,
        remat=False,
        use_pallas=False,
    )
    if cfg.num_experts:
        upd.update(
            num_experts=4,
            num_experts_padded=4,
            top_k=min(cfg.top_k, 2),
            d_ff_expert=d_model,
            shared_expert_ff=d_model if cfg.shared_expert_ff else 0,
        )
    if cfg.lru_width:
        upd.update(lru_width=d_model)
    if cfg.is_encoder_decoder:
        upd.update(num_encoder_layers=2, encoder_positions=64)
    if cfg.frontend == "vision":
        upd.update(num_prefix_embeddings=8)
    return dataclasses.replace(cfg, **upd)
