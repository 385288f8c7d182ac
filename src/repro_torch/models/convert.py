"""The reference's parameter trees in the port's layout.

The reference keeps a stack's layers as scanned super-blocks —
``blocks`` (a tuple of one dict a layer of the period, each leaf with a
leading ``n_groups`` axis) and an unrolled ``tail`` list
(``layer_plan``) — where the port keeps one module a layer.  Layer
``g·period + j`` is ``blocks[j]`` at index ``g``; the tail follows.
zamba2's shared attention block is one subtree (``shared_attn``) in the
parameters, and in a cache the extra ``blocks[period]``, one entry a
group.  An encoder–decoder's ``encoder`` stack maps onto
``Model.encoder`` the same way, at its own depth (``encoder_layers``);
its decoder layers carry the cross leaves (``norm_cross``, ``cross``,
and in a cache ``ck``/``cv``).  Leaves keep their names and layout, so
every leaf copies as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import encoder_config, layer_plan


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def reference_layers(stack: dict, cfg: ModelConfig,
                     depth: int | None = None) -> list[dict]:
    """A reference ``{"blocks", "tail"}`` stack (parameters or cache) of
    ``depth`` layers (the decoder's ``n_layers`` by default; pass the
    encoder's configuration and ``encoder_layers`` for its stack), as
    one flat ``{leaf path: array}`` dict a layer in layer order."""
    period, n_groups, tail_kinds = layer_plan(cfg, depth)
    groups = {np.shape(v)[0] for j in range(period)
              for v in _flatten(stack["blocks"][j]).values()}
    if groups != {n_groups} or len(stack["tail"]) != len(tail_kinds):
        raise ValueError(
            f"the stack holds {groups} scanned groups and a tail of "
            f"{len(stack['tail'])}; a depth of "
            f"{depth or cfg.n_layers} needs {n_groups} and "
            f"{len(tail_kinds)}")
    layers = [
        {k: np.asarray(v)[g] for k, v in _flatten(stack["blocks"][j]).items()}
        for g in range(n_groups) for j in range(period)
    ]
    layers += [{k: np.asarray(v) for k, v in _flatten(entry).items()}
               for entry in stack["tail"]]
    return layers


def reference_shared(cache: dict, cfg: ModelConfig) -> list[dict]:
    """A reference cache's shared-block entries (``blocks[period]``), one
    flat ``{"k", "v"}`` dict a group; empty without a shared block."""
    if not cfg.shared_attn_period:
        return []
    period, n_groups, _ = layer_plan(cfg)
    entry = _flatten(cache["blocks"][period])
    return [{k: np.asarray(v)[g] for k, v in entry.items()}
            for g in range(n_groups)]


def reference_leaves(cfg: ModelConfig, names) -> list[list[str]]:
    """The port's parameter ``names`` grouped as the reference's leaves:
    a scanned group's layers at one position of the period are one
    stacked leaf (``layers.{g·period + j}.<path>`` over every group g);
    a tail layer's tensors, and every tensor outside the stacks, are
    leaves of their own.  Leaves in order of their first name."""
    plans = {"layers": layer_plan(cfg)}
    if cfg.is_enc_dec:
        plans["encoder"] = layer_plan(encoder_config(cfg), cfg.encoder_layers)
    leaves: dict = {}
    for name in names:
        stack, _, rest = name.partition(".")
        key = name
        if stack in plans:
            index, _, path = rest.partition(".")
            period, n_groups, _ = plans[stack]
            if int(index) < period * n_groups:
                key = (stack, int(index) % period, path)
        leaves.setdefault(key, []).append(name)
    return list(leaves.values())


def params_from_reference(tree: dict, cfg: ModelConfig) -> dict:
    """The reference's parameter tree (numpy arrays) as the port's
    ``Model`` state dict of CPU tensors, for
    ``Model(cfg, device="meta").load_state_dict(state, assign=True)``."""
    state = {"embed.table": tree["embed"]["table"],
             "final_norm.scale": tree["final_norm"]["scale"]}
    if "lm_head" in tree:
        state["lm_head.w"] = tree["lm_head"]["w"]
    if "shared_attn" in tree:
        state.update({f"shared_attn.{k}": v
                      for k, v in _flatten(tree["shared_attn"]).items()})
    for i, layer in enumerate(reference_layers(tree["decoder"], cfg)):
        state.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    if "encoder" in tree:
        state["enc_final_norm.scale"] = tree["enc_final_norm"]["scale"]
        for i, layer in enumerate(reference_layers(
                tree["encoder"], encoder_config(cfg), cfg.encoder_layers)):
            state.update({f"encoder.{i}.{k}": v for k, v in layer.items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
