"""The language-model stack: layers, attention, the Mixture-of-Experts
FFN, the recurrent blocks (Mamba2, mLSTM, sLSTM), the model (decoder-only
or encoder–decoder), the serving path (prefill and cache decode) and the
converter from the reference's parameter trees — ports of
``repro/models`` for every configured layer kind."""
