"""The language-model stack: layers, attention, the Mixture-of-Experts
FFN, the decoder model, the serving path (prefill and KV-cache decode)
and the converter from the reference's parameter trees — ports of
``repro/models`` for the attention layer kinds."""
