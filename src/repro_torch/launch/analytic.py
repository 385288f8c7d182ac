"""Analytic FLOP / HBM-traffic model per (arch × shape) — the roofline's
compute and memory terms; the port of ``repro/launch/analytic.py``.

``step_flops`` and ``step_hbm_bytes`` are the reference's, unchanged
(they hold no hardware constant); the constants are an NVIDIA H100
SXM's in place of the reference's TPU v5e.

MODEL_FLOPS convention (assignment §Roofline): 6·N·D for dense training
(N params, D tokens), 6·N_active·D for MoE; attention adds
12·L·H·hd·S²·(causal ½)·D_batch terms.  Forward-only steps use 2·N·D.
The HBM model counts the bytes a chip must move per step given the
sharding policy: TP-sharded weights are read once per pass (fwd, bwd,
remat-fwd), gradients/optimizer sharded by FSDP, KV cache read per
decode step, activations written/read once per layer boundary
(everything interior is assumed fused).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec

# NVIDIA H100 SXM peaks (NVIDIA H100 data sheet; dense rates, without
# sparsity, at the 700 W limit)
PEAK_FLOPS = 989e12          # bf16 tensor cores / chip
HBM_BW = 3.35e12             # bytes/s / chip
#: NVLink 4: 18 links a GPU, 900 GB/s both ways together, so 25 GB/s
#: each way a link; through the NVSwitch a collective uses every link.
NVLINK_BW = 25e9             # bytes/s / link / direction
NVLINK_LINKS = 18
#: elementwise min/max throughput (outside the tensor cores): the fp32
#: non-tensor rate, 67e12 ops/s, for every width, as ``chip_smoke.py``'s
#: kernel bounds take it (fp64 runs at half of it).  Used for the
#: morphology cells: crediting the tensor-core peak to elementwise ops
#: would overstate headroom ~15×.
VPU_OPS = {1: 67e12, 2: 67e12, 4: 67e12, 8: 67e12}
#: device memory a chip (NVIDIA H100 SXM data sheet: 80 GB HBM3); the
#: dry run's ``fits_80g``
HBM_CAPACITY = 80e9
#: one small message between two GPUs over NVLink, on the device (NCCL
#: send/receive of 4 bytes, one way, timed by CUDA events with the
#: host's launches hidden): ``python -m repro_torch.launch.link_latency``
#: on four NVIDIA H100 80GB HBM3 at 700 W measured 6.99 µs (an eager
#: program pays ~82 µs a message on the host clock)
NVLINK_LATENCY = 6.99e-6


@dataclasses.dataclass
class Terms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float | None = None

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)


def _attn_flops_per_layer(cfg: ModelConfig, s: int, kind: str,
                          causal: bool = True) -> float:
    """QK^T + PV flops per token-batch row (batch excluded)."""
    h, hd = cfg.n_heads, cfg.head_dim
    if kind == "attn_local" and cfg.sliding_window:
        ctx = min(cfg.sliding_window, s)
    else:
        ctx = s / 2 if causal else s
    return 2.0 * 2.0 * s * ctx * h * hd


def _layer_linear_flops(cfg: ModelConfig, kind: str) -> float:
    """Per-token matmul flops (fwd) for one layer of ``kind``."""
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    glu = cfg.activation in ("silu", "geglu")
    if kind.startswith("attn"):
        fl = 2 * d * (h * hd * 2 + kv * hd * 2)          # qkvo
        if cfg.moe is not None:
            m = cfg.moe
            fl += 2 * d * m.n_experts                     # router
            fl += (m.top_k + m.n_shared) * 2 * d * m.d_expert * 3
            if m.dense_residual_ff:
                fl += 2 * d * m.dense_residual_ff * 3
        elif f:
            fl += 2 * d * f * (3 if glu else 2)
        return fl
    if kind == "mamba2":
        d_in = 2 * d
        nh = d_in // cfg.ssm_head_dim
        fl = 2 * d * (2 * d_in + 2 * cfg.ssm_state + nh) + 2 * d_in * d
        # ssd: chunked quadratic (chunk=128) + state products
        chunk = 128
        fl += 2 * chunk * cfg.ssm_state * 2              # scores per token
        fl += 2 * chunk * d_in                            # intra y
        fl += 4 * cfg.ssm_state * d_in                    # state in/out
        return fl
    if kind == "mlstm":
        d_in = 2 * d
        fl = 2 * d * (3 * d_in + d_in) + 2 * d_in * d
        chunk = 128
        p = d_in // cfg.n_heads
        fl += 2 * chunk * d_in * 2                        # scores + out
        fl += 4 * p * d_in                                # state update/query
        return fl
    if kind == "slstm":
        fl = 2 * d * 4 * d + 2 * d * d
        fl += 2 * 4 * d * (d // cfg.n_heads)              # recurrent (blocked)
        return fl
    raise ValueError(kind)


def step_flops(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Global model flops for one step (all chips together)."""
    s = shape.seq_len
    b = shape.global_batch
    train = shape.step == "train"
    tokens = b * (1 if shape.step == "decode" else s)

    per_tok = 0.0
    attn = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        per_tok += _layer_linear_flops(cfg, kind)
        if kind.startswith("attn"):
            if shape.step == "decode":
                ctx = (min(cfg.sliding_window, s)
                       if kind == "attn_local" and cfg.sliding_window else s)
                attn += 2.0 * 2.0 * ctx * cfg.n_heads * cfg.head_dim * b
            else:
                attn += _attn_flops_per_layer(cfg, s, kind) * b
    if cfg.shared_attn_period:
        napp = cfg.n_layers // cfg.shared_attn_period
        per_tok += napp * _layer_linear_flops(cfg, "attn")
        if shape.step == "decode":
            attn += napp * 2.0 * 2.0 * s * cfg.n_heads * cfg.head_dim * b
        else:
            attn += napp * _attn_flops_per_layer(cfg, s, "attn") * b
    if cfg.is_enc_dec:
        enc_s = min(s, 4096)
        enc_tok = b * enc_s
        enc_per_tok = _layer_linear_flops(
            dataclasses.replace(cfg, moe=None), "attn")
        per_tok_enc = enc_per_tok * cfg.encoder_layers
        attn += cfg.encoder_layers * _attn_flops_per_layer(
            cfg, enc_s, "attn", causal=False) * b
        # cross attention in every decoder layer
        per_tok += cfg.n_layers * 2 * cfg.d_model * (
            cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim)
        if shape.step == "decode":
            attn += cfg.n_layers * 2.0 * 2.0 * enc_s * cfg.n_heads \
                * cfg.head_dim * b
        else:
            # cross attention: S decoder queries × enc_s keys per layer
            attn += cfg.n_layers * 2.0 * 2.0 * s * enc_s * cfg.n_heads \
                * cfg.head_dim * b
    else:
        per_tok_enc = 0.0
        enc_tok = 0

    # embedding + head
    head = 2 * cfg.d_model * cfg.vocab_size
    fwd = per_tok * tokens + per_tok_enc * enc_tok + attn + head * tokens
    mult = 3.0 if train else 1.0          # bwd = 2x fwd
    total = fwd * mult
    n_active = cfg.active_param_count()
    model_flops = (6 if train else 2) * n_active * tokens
    return {"flops": total, "model_flops": model_flops, "fwd_flops": fwd}


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh_shape: dict,
                   accum: int = 1) -> float:
    """Per-chip HBM traffic (bytes) per step under the sharding policy."""
    model_par = mesh_shape.get("model", 1)
    data_par = math.prod(v for k, v in mesh_shape.items() if k != "model")
    chips = model_par * data_par
    pbytes = {"float32": 4, "bfloat16": 2}.get(cfg.param_dtype, 4)
    abytes = {"float32": 4, "bfloat16": 2}.get(cfg.activation_dtype, 2)

    n_total = cfg.param_count()
    n_active = cfg.active_param_count()
    # weights a chip reads per pass: TP-sharded (1/model_par) of the
    # *active* params (routed experts it does not own are other chips' work)
    w_read = n_active * pbytes / model_par

    s = shape.seq_len
    b = shape.global_batch
    if shape.step == "train":
        # fwd + bwd + remat-recompute reads of weights; grads + adam rw
        traffic = 3 * w_read * accum
        opt = n_total / chips * pbytes  # param shard rw (ZeRO)
        traffic += 6 * opt              # grad w + m rw + v rw + p rw
        act = b * s * cfg.d_model * abytes / data_par / model_par
        traffic += act * cfg.n_layers * 4      # layer-boundary acts, fwd+bwd
        return traffic
    if shape.step == "prefill":
        act = b * s * cfg.d_model * abytes / data_par / model_par
        return w_read + act * cfg.n_layers * 2
    # decode: weights + full KV/state read per step
    kv_bytes = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind.startswith("attn"):
            kv_bytes += 2 * b * s * cfg.n_kv_heads * cfg.head_dim * abytes
        elif kind == "mamba2":
            d_in = 2 * cfg.d_model
            kv_bytes += b * (d_in // cfg.ssm_head_dim) * cfg.ssm_head_dim \
                * cfg.ssm_state * 4
        elif kind == "mlstm":
            p = 2 * cfg.d_model // cfg.n_heads
            kv_bytes += b * cfg.n_heads * p * p * 4
        elif kind == "slstm":
            kv_bytes += 4 * b * cfg.d_model * 4
    if cfg.shared_attn_period:
        kv_bytes += (cfg.n_layers // cfg.shared_attn_period) * 2 * b * s \
            * cfg.n_kv_heads * cfg.head_dim * abytes
    # the cache is sharded over every mesh axis (batch/seq -> data axes,
    # heads -> model)
    return w_read + kv_bytes / chips


def roofline_terms(cfg: ModelConfig, shape: ShapeSpec, mesh_shape: dict,
                   hlo: dict | None = None, chips: int | None = None) -> Terms:
    chips = chips or math.prod(mesh_shape.values())
    fl = step_flops(cfg, shape)
    compute_s = fl["flops"] / (chips * PEAK_FLOPS)
    memory_s = step_hbm_bytes(cfg, shape, mesh_shape) / HBM_BW
    if hlo is not None:
        coll = hlo.get("collective_bytes_total", 0.0)
        # per-device bytes over every NVLink link, one direction
        collective_s = coll / (NVLINK_LINKS * NVLINK_BW)
        hlo_flops = hlo.get("dot_flops")
    else:
        collective_s, hlo_flops = 0.0, None
    return Terms(compute_s, memory_s, collective_s, fl["model_flops"],
                 hlo_flops)
