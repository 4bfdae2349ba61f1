"""Language-model weights and prompts from a numpy seed, in the reference's
layout, for the parity tests and ``chip_smoke.py`` (numpy only: the card's
machine has no JAX).

:func:`lm_weights` returns the tree ``repro.models.lm.init_params`` builds
(f32 masters, layers stacked on a leading axis) with the same
distributions for the matrices (MoE: the router and the experts); norm
weights are drawn near 1 rather than set to 1, so that a norm applied to
the wrong axis or not at all shows.
For encdec the decoder layers add ``ln_x`` and ``xattn`` and the tree
adds ``enc_layers`` (stacked) and ``enc_norm``; a vlm's tree is the
dense one.  :func:`frames` and :func:`vis_embed` draw the stub encoder
and vision inputs.
For the Mamba2 kinds (ssm, hybrid) the ``ssm`` leaves the reference
initialises to constants are drawn too: conv biases, ``D``, ``dt_bias``
and ``norm_w`` away from 0 / 1 / log(e - 1), ``A_log`` = log of U(1, 16)
(the reference's range), and conv_B and conv_C independently (the
reference draws both from one key), so that a skipped term or a swap of B
and C shows.  The JAX side takes the tree as it is; the port takes it
through ``repro_torch.convert.lm_params_from_jax``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: The committed serve reference (src/repro_torch/testdata/
#: llama3_smoke_serve_ref.json): llama3-8b SMOKE in f32, weights from
#: ``lm_weights(cfg, SERVE_REF["seed"])``, prompt from ``prompt(...)``.
SERVE_REF = dict(arch="llama3-8b", seed=0, batch=2, steps=8)
#: The committed MoE serve references (src/repro_torch/testdata/
#: {mixtral,grok}_smoke_serve_ref.json): the SMOKE configs in f32, a prompt
#: of ``steps`` tokens (past mixtral SMOKE's window of 32: its decode ring
#: wraps), ``new`` greedy tokens; decode is held against prefills at
#: ``capacity_factor`` E / k or more, where no token is dropped.
MOE_SERVE_REF = {arch: dict(arch=arch, seed=0, batch=2, steps=40, new=4,
                            capacity_factor=4.0)
                 for arch in ("mixtral-8x22b", "grok-1-314b")}
#: The committed Mamba2 serve references (src/repro_torch/testdata/
#: {mamba2,zamba2}_smoke_serve_ref.json): the SMOKE configs in f32, a
#: prompt of ``steps`` tokens (two chunks of 16), ``new`` greedy tokens.
SSM_SERVE_REF = {arch: dict(arch=arch, seed=0, batch=2, steps=32, new=4)
                 for arch in ("mamba2-2.7b", "zamba2-2.7b")}
#: The committed encoder-decoder and vision-language serve references
#: (src/repro_torch/testdata/{whisper,internvl2}_smoke_serve_ref.json): the
#: SMOKE configs in f32, a prompt of ``steps`` tokens, ``new`` greedy
#: tokens; whisper's frames from ``frames(cfg, seed, batch)``, internvl2's
#: patch embeddings from ``vis_embed(cfg, seed, batch)``.
MM_SERVE_REF = {arch: dict(arch=arch, seed=0, batch=2, steps=12, new=4)
                for arch in ("whisper-small", "internvl2-26b")}
#: The committed training references (src/repro_torch/testdata/
#: {llama3,mamba2,mixtral,whisper}_smoke_train_ref.json): the SMOKE
#: configs in f32, weights from ``lm_weights(cfg, seed)`` as f32 masters,
#: ``steps`` train steps of ``OptConfig(lr=1e-3, warmup_steps=2,
#: total_steps=50)`` on ``SyntheticDataset(DataConfig(vocab, seq, batch,
#: seed))`` batches (whisper's ``frames(cfg, seed, batch)`` in every
#: batch); llama3 accumulates two micro-batches, mixtral compresses its
#: gradients (int8 with error feedback).
TRAIN_REF = {arch: dict(arch=arch, seed=0, batch=4, seq=32, steps=4,
                        micro_batches=2 if arch == "llama3-8b" else 1,
                        grad_compress=arch == "mixtral-8x22b")
             for arch in ("llama3-8b", "mamba2-2.7b", "mixtral-8x22b",
                          "whisper-small")}


def lm_weights(cfg, seed: int) -> dict:
    if cfg.kind in ("ssm", "hybrid"):
        return _ssm_lm_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    d, ff, V, L, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers, cfg.hd
    H, K = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    def norm(shape):
        return (1.0 + normal(shape, 0.1)).astype(np.float32)

    def attention():
        a = {"wq": normal((L, d, H * hd), d ** -0.5),
             "wk": normal((L, d, K * hd), d ** -0.5),
             "wv": normal((L, d, K * hd), d ** -0.5),
             "wo": normal((L, H * hd, d), (H * hd) ** -0.5)}
        if cfg.qk_norm:
            a["q_norm"] = norm((L, hd))
            a["k_norm"] = norm((L, hd))
        return a

    attn = attention()
    # the draws in the order the dense tree has always taken them
    embed, final_norm = normal((V, d), 0.02), norm((d,))
    ln1, ln2 = norm((L, d)), norm((L, d))
    if cfg.kind == "moe":
        E = cfg.n_experts
        ffn = {"moe": {"router": normal((L, d, E), d ** -0.5),
                       "wg": normal((L, E, d, ff), d ** -0.5),
                       "wu": normal((L, E, d, ff), d ** -0.5),
                       "wd": normal((L, E, ff, d), ff ** -0.5)}}
    else:
        ffn = {"mlp": {"wg": normal((L, d, ff), d ** -0.5),
                       "wu": normal((L, d, ff), d ** -0.5),
                       "wd": normal((L, ff, d), ff ** -0.5)}}
    p = {"embed": embed, "final_norm": final_norm,
         "layers": {"ln1": ln1, "attn": attn, "ln2": ln2, **ffn}}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, V), d ** -0.5)
    if cfg.kind == "encdec":
        p["layers"].update(ln_x=norm((L, d)), xattn=attention())
        enc = dataclasses.replace(cfg, kind="dense", n_layers=cfg.n_enc_layers,
                                  n_enc_layers=0)
        p["enc_layers"] = lm_weights(enc, seed + 2)["layers"]
        p["enc_norm"] = norm((d,))
    return p


def _ssm_lm_weights(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    d_in = cfg.ssm_expand * d
    H, N, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv

    def normal(shape, scale, loc=0.0):
        return (np.float32(loc) + rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale)).astype(np.float32)

    def norm(shape):
        return normal(shape, 0.1, 1.0)

    ssm = {"w_z": normal((L, d, d_in), d ** -0.5),
           "w_x": normal((L, d, d_in), d ** -0.5),
           "w_B": normal((L, d, N), d ** -0.5),
           "w_C": normal((L, d, N), d ** -0.5),
           "w_dt": normal((L, d, H), d ** -0.5),
           "w_out": normal((L, d_in, d), d_in ** -0.5),
           "conv_x": normal((L, K, d_in), 0.2),
           "conv_B": normal((L, K, N), 0.2),
           "conv_C": normal((L, K, N), 0.2),
           "conv_bx": normal((L, d_in), 0.1),
           "conv_bB": normal((L, N), 0.1),
           "conv_bC": normal((L, N), 0.1),
           "A_log": np.log(rng.uniform(1.0, 16.0, (L, H))).astype(np.float32),
           "D": normal((L, H), 0.5, 1.0),
           "dt_bias": normal((L, H), 0.5, np.log(np.e - 1)),
           "norm_w": norm((L, d_in))}
    p = {"embed": normal((V, d), 0.02), "final_norm": norm((d,)),
         "layers": {"ln1": norm((L, d)), "ssm": ssm}}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, V), d ** -0.5)
    if cfg.kind == "hybrid":
        one = dataclasses.replace(cfg, kind="dense", n_layers=1)
        shared = lm_weights(one, seed + 1)["layers"]
        p["shared_attn"] = {k: ({n: a[0] for n, a in v.items()}
                                if isinstance(v, dict) else v[0])
                            for k, v in shared.items()}
    return p


def frames(cfg, seed: int, batch: int) -> np.ndarray:
    """f32 (batch, enc_seq, d) stub frame embeddings, N(0, 1)."""
    rng = np.random.default_rng(seed + 3)
    return rng.standard_normal((batch, cfg.enc_seq, cfg.d_model),
                               dtype=np.float32)


def vis_embed(cfg, seed: int, batch: int) -> np.ndarray:
    """f32 (batch, n_vis_tokens, d) stub patch embeddings, N(0, 1)."""
    rng = np.random.default_rng(seed + 4)
    return rng.standard_normal((batch, cfg.n_vis_tokens, cfg.d_model),
                               dtype=np.float32)


def prompt(cfg, seed: int, batch: int, length: int) -> np.ndarray:
    """int32 (batch, length) tokens in [0, vocab)."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab, (batch, length)).astype(np.int32)


def port_train_run(arch: str, device: str, steps=None) -> tuple:
    """The port training the SMOKE config of ``arch`` as ``TRAIN_REF[arch]``
    says, on ``device`` (what ``tests/torch_parity.py``'s ``jax_train_run``
    does in the JAX package).  Returns (the batches' tokens (steps, B, T)
    int32, per-step metrics ``{"loss", "grad_norm", "lr"}`` lists of
    floats, the final (params, opt state))."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.runtime.data import DataConfig, SyntheticDataset
    from repro_torch.runtime.optimizer import OptConfig, init_opt
    from repro_torch.runtime.train import make_train_step
    ref = TRAIN_REF[arch]
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = lm_params_from_jax(lm_weights(cfg, ref["seed"]), cfg, device,
                                masters=True)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50,
                        grad_compress=ref["grad_compress"])
    opt = init_opt(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, micro_batches=ref["micro_batches"],
                           device=device)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq=ref["seq"],
                                     global_batch=ref["batch"],
                                     seed=ref["seed"]), device=device)
    extra = ({"frames": torch.from_numpy(frames(cfg, ref["seed"],
                                                ref["batch"])).to(device)}
             if cfg.kind == "encdec" else {})
    toks, metrics = [], {"loss": [], "grad_norm": [], "lr": []}
    for s in range(ref["steps"] if steps is None else steps):
        batch = dict(ds.batch_at(s), **extra)
        params, opt, m = step(params, opt, batch)
        toks.append(batch["tokens"].cpu().numpy())
        for k in metrics:
            metrics[k].append(float(m[k]))
    return np.stack(toks), metrics, (params, opt)
