"""The port's DLRM, transformer, serving steps and LM serving driver on the
CPU against the JAX package, on its own parameters carried across with
``repro_torch.models.convert``.

Tolerances: DLRM logits within 1e-5 relative; transformer logits within
1e-4 of JAX's (f32 throughout; the port's prefill attention sums in
another order than JAX's XLA einsums) and the port's own decode within
2e-4 of its prefill, the JAX suite's bar (tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as j_dlrm_cfg
from repro.configs import shapes as j_shapes
from repro.configs import starcoder2_3b as j_sc2_cfg
from repro.dist.sharding import SERVE_RULES
from repro.launch import serve as j_serve
from repro.models import dlrm as jdlrm
from repro.models import transformer as jtf
from repro_torch.configs import dlrm_rm2 as t_dlrm_cfg
from repro_torch.configs import registry as t_registry
from repro_torch.configs import shapes as t_shapes
from repro_torch.configs import starcoder2_3b as t_sc2_cfg
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import convert
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import (apply_rope, layer_norm, rms_norm)

#: tests/test_models.py's BASE config
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)
VARIANTS = {
    "rmsnorm-swiglu": dict(),
    "layernorm-gelu": dict(norm="layernorm", mlp="gelu"),
    "qk_norm": dict(qk_norm=True),
    "window8": dict(sliding_window=8),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def lm_pair(variant, seed=0):
    over = VARIANTS[variant]
    jcfg = jtf.TransformerConfig(name="t", dtype=jnp.float32, **BASE, **over)
    tcfg = ttf.TransformerConfig(name="t", dtype=torch.float32, **BASE,
                                 **over)
    jp = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, convert.transformer_from_numpy(
        tcfg, np_tree(jp), device="cpu")


def dlrm_pair(seed=0):
    jcfg, tcfg = j_dlrm_cfg.smoke_config(), t_dlrm_cfg.smoke_config()
    jp = jdlrm.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, convert.dlrm_from_numpy(tcfg, np_tree(jp),
                                                   device="cpu")


def dlrm_batch(cfg, rng, b, h=1):
    return {"dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            "sparse_ids": rng.integers(0, cfg.vocab_size,
                                       (b, cfg.n_sparse, h)).astype(np.int32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def close_rel(got, want, rel):
    """Within ``rel`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# Layers and configs
# ---------------------------------------------------------------------------

class TestLayers:
    def test_norms_and_rope_match_jax(self):
        from repro.models import layers as jl
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
        s = rng.normal(size=16).astype(np.float32)
        b = rng.normal(size=16).astype(np.float32)
        pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
        tx, ts, tb = map(torch.from_numpy, (x, s, b))
        close(rms_norm(tx, ts), jl.rms_norm(x, s), 1e-6)
        close(layer_norm(tx, ts, tb), jl.layer_norm(x, s, b), 1e-5)
        close(apply_rope(tx, torch.from_numpy(pos), 1e5),
              jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e5), 1e-5)


class TestConfigs:
    def test_shape_tables_equal_jax(self):
        assert t_shapes.LM_SHAPES == {
            k: t_shapes.LMShape(**dataclasses.asdict(v))
            for k, v in j_shapes.LM_SHAPES.items()}
        assert t_shapes.RECSYS_SHAPES == {
            k: t_shapes.RecsysShape(**dataclasses.asdict(v))
            for k, v in j_shapes.RECSYS_SHAPES.items()}

    @pytest.mark.parametrize("which", ["full_config", "smoke_config"])
    def test_configs_equal_jax(self, which):
        for jmod, tmod in ((j_sc2_cfg, t_sc2_cfg), (j_dlrm_cfg, t_dlrm_cfg)):
            j, t = getattr(jmod, which)(), getattr(tmod, which)()
            for f in dataclasses.fields(t):
                if f.name in ("dtype", "param_dtype"):
                    assert str(getattr(t, f.name))[6:] == \
                        jnp.dtype(getattr(j, f.name)).name
                else:
                    assert getattr(t, f.name) == getattr(j, f.name), f.name

    def test_full_starcoder2_param_count(self):
        cfg = t_sc2_cfg.full_config()
        assert cfg.n_params() == j_sc2_cfg.full_config().n_params()

    def test_registry_names_the_roadmap_for_unported_archs(self):
        assert t_registry.get_arch("dlrm-rm2").kind == "recsys"
        with pytest.raises(KeyError, match="A13"):
            t_registry.get_arch("qwen3-32b")

    def test_moe_and_padded_heads_raise(self):
        cfg = ttf.TransformerConfig(name="t", dtype=torch.float32, **BASE)
        for over in (dict(n_experts=4), dict(n_heads_padded=8)):
            with pytest.raises(NotImplementedError, match="A13"):
                ttf.init_params(dataclasses.replace(cfg, **over),
                                device="cpu")

    def test_entry_points_default_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="cuda"):
            tdlrm.init_params(t_dlrm_cfg.smoke_config())


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------

class TestDLRM:
    def test_param_names_are_jax_paths(self):
        _, _, jp, tp = dlrm_pair()
        names = {n for n, _ in tp.named_parameters()}
        assert names == {"tables", "bot.0.w", "bot.0.b", "bot.1.w",
                         "bot.1.b", "top.0.w", "top.0.b", "top.1.w",
                         "top.1.b"}
        assert tuple(tp.tables.shape) == jp["tables"].shape

    @pytest.mark.parametrize("h", [1, 3])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_forward_matches_jax(self, seed, h):
        jcfg, tcfg, jp, tp = dlrm_pair(seed)
        batch = dlrm_batch(tcfg, np.random.default_rng(seed), 37, h)
        want = jdlrm.forward(jcfg, jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                             SERVE_RULES)
        got = t_steps.serve_step(tcfg, tp, torch_batch(batch))
        assert got.shape == (37,)
        close_rel(got, want, 1e-5)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_retrieval_matches_jax(self, seed):
        jcfg, tcfg, jp, tp = dlrm_pair(seed)
        rng = np.random.default_rng(seed)
        batch = dlrm_batch(tcfg, rng, 1)
        # distinct scores: candidates on well-separated multiples of a
        # random direction, shuffled
        n = 500
        direction = rng.normal(size=tcfg.embed_dim).astype(np.float32)
        cand = (rng.permutation(n)[:, None] * direction[None] / 50.0
                + rng.normal(size=(n, tcfg.embed_dim)) * 1e-3)
        batch["candidates"] = cand.astype(np.float32)
        jv, ji = jdlrm.retrieval_score(
            jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()},
            SERVE_RULES, top_k=20)
        tv, ti = t_steps.retrieval_step(tcfg, tp, torch_batch(batch), 20)
        assert np.unique(np.asarray(jv)).size == 20
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        close_rel(tv, jv, 1e-5)


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------

class TestTransformer:
    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_forward_matches_jax(self, variant):
        jcfg, tcfg, jp, tp = lm_pair(variant)
        toks = np.random.default_rng(1).integers(0, 256, (2, 24))
        want, _ = jtf.forward(jcfg, jp, jnp.asarray(toks), SERVE_RULES)
        got = t_steps.prefill_step(tcfg, tp,
                                   {"tokens": torch.from_numpy(toks)})
        assert got.shape == (2, 24, 256)
        close(got, want, 1e-4)

    @pytest.mark.parametrize("variant", ["window8", "qk_norm"])
    def test_decode_matches_jax_step_by_step(self, variant):
        """Twenty steps; under window 8 the cache is an 8-slot ring."""
        jcfg, tcfg, jp, tp = lm_pair(variant)
        toks = np.random.default_rng(2).integers(0, 256, (2, 20))
        jc = jtf.init_kv_cache(jcfg, 2, 24, dtype=jnp.float32)
        tc = ttf.init_kv_cache(tcfg, 2, 24, dtype=torch.float32,
                               device="cpu")
        assert tc["k"].shape == jc["k"].shape
        jdecode = jax.jit(lambda p, c, x, pos: jtf.decode_step(
            jcfg, p, c, x, pos, SERVE_RULES))
        for t in range(20):
            jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]), t)
            tl, tc = ttf.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
            close(tl, jl, 1e-4)
        np.testing.assert_array_equal(tc["positions"].numpy(),
                                      np.asarray(jc["positions"]))
        close(tc["k"], jc["k"], 1e-4)

    @pytest.mark.parametrize("variant", ["qk_norm", "window8"])
    def test_decode_matches_prefill(self, variant):
        _, tcfg, _, tp = lm_pair(variant)
        toks = torch.from_numpy(
            np.random.default_rng(3).integers(0, 256, (2, 20)))
        logits = ttf.forward(tcfg, tp, toks)
        cache = ttf.init_kv_cache(tcfg, 2, 24, dtype=torch.float32,
                                  device="cpu")
        outs = []
        for t in range(20):
            lg, cache = ttf.decode_step(tcfg, tp, cache, toks[:, t:t + 1], t)
            outs.append(lg)
        close(torch.stack(outs, 1), logits.numpy(), 2e-4)

    def test_param_names_are_jax_paths(self):
        _, _, jp, tp = lm_pair("layernorm-gelu")
        flat = {"/".join(str(getattr(k, "key", k)) for k in path)
                .replace("/", "."): np.shape(v)
                for path, v in jax.tree_util.tree_leaves_with_path(jp)}
        assert {n: tuple(p.shape) for n, p in tp.named_parameters()} == flat

    def test_serve_lm_tokens_match_jax(self, monkeypatch):
        """The smoke config through both serving drivers, on equal
        parameters: the same requests come back with the same tokens."""
        jcfg = j_sc2_cfg.smoke_config()
        tcfg = t_sc2_cfg.smoke_config()
        jp = jtf.init_params(jcfg, jax.random.key(0))
        tp = convert.transformer_from_numpy(tcfg, np_tree(jp), device="cpu")
        want = j_serve.serve_lm(jcfg, batch=2, prompt_len=8, gen=8,
                                n_requests=3)
        got = t_serve.serve_lm(tcfg, batch=2, prompt_len=8, gen=8,
                               n_requests=3, params=tp, device="cpu")
        assert got == want

    def test_serve_cli_on_cpu(self, capsys, monkeypatch):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "4", "--gen", "4"])
        t_serve.main()
        assert "served 4 requests in 8 steps" in capsys.readouterr().out


class TestWholeSlice:
    """The three ported steps on the smoke configs against what the JAX
    step functions compute (``launch/steps.py``): ``transformer.forward``,
    ``dlrm.forward`` and ``dlrm.retrieval_score`` under SERVE_RULES with
    no mesh."""

    def test_steps_match_jax(self):
        jcfg, tcfg = j_sc2_cfg.smoke_config(), t_sc2_cfg.smoke_config()
        jp = jtf.init_params(jcfg, jax.random.key(5))
        tp = convert.transformer_from_numpy(tcfg, np_tree(jp), device="cpu")
        toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 40))
        want, _ = jtf.forward(jcfg, jp, jnp.asarray(toks), SERVE_RULES, None)
        got = t_steps.prefill_step(tcfg, tp,
                                   {"tokens": torch.from_numpy(toks)})
        close(got, want, 1e-4)

        jc, tc, jdp, tdp = dlrm_pair(5)
        rng = np.random.default_rng(5)
        batch = dlrm_batch(tc, rng, 64)
        want = jdlrm.forward(jc, jdp, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                             SERVE_RULES, None)
        close_rel(t_steps.serve_step(tc, tdp, torch_batch(batch)), want, 1e-5)
        rb = dlrm_batch(tc, rng, 1)
        rb["candidates"] = rng.normal(size=(300, tc.embed_dim)) \
            .astype(np.float32)
        jv, ji = jdlrm.retrieval_score(
            jc, jdp, {k: jnp.asarray(v) for k, v in rb.items()},
            SERVE_RULES, None)
        tv, ti = t_steps.retrieval_step(tc, tdp, torch_batch(rb))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        close_rel(tv, jv, 1e-5)
