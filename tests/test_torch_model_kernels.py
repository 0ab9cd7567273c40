"""The port's embedding-bag (K4) and flash-attention (K5) dispatch on the
CPU (their plain versions) against the JAX package's functions: its
reference oracles and its Pallas kernels in interpret mode.

Tolerances are the JAX suite's ``tol_for`` (tests/test_kernels.py):
rtol = atol = 2e-5 in float32 (3e-5 on the long-KV case, as there), and
2e-2 in bfloat16, where the JAX functions round their products and scores
to bfloat16 and the port computes in float32 and rounds once.  The
``cuda`` tests hold the hand-written kernels to their plain versions on
the card and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.embedding_bag import embedding_bag_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import dlrm as jdlrm
from repro_torch.kernels.embedding_bag import ops as tbag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref as \
    tbag_ref
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import attention_ref as tfa_ref
from repro_torch.models import dlrm as tdlrm

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def to_torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# K4: embedding bag
# ---------------------------------------------------------------------------

#: (V, D, B, H): B never a multiple of 128 (the TPU kernel pads it)
BAG_CASES = [(16, 16, 1, 1), (300, 64, 37, 3), (3000, 128, 130, 6),
             (1000, 64, 257, 1), (77, 16, 5, 4)]


class TestEmbeddingBag:
    @pytest.mark.parametrize("dt", sorted(DTYPES))
    @pytest.mark.parametrize("case", BAG_CASES, ids=str)
    def test_matches_jax(self, case, dt):
        v, d, b, h = case
        jdt, tdt, tol = DTYPES[dt]
        rng = np.random.default_rng(v * 7 + b)
        table = jnp.asarray(rng.normal(size=(v, d)), jdt)
        ids = rng.integers(0, v, (b, h)).astype(np.int32)
        ids[0, :] = ids[0, 0]                  # a bag of repeated ids
        got = tbag.embedding_bag(to_torch(table, tdt), torch.from_numpy(ids))
        assert got.dtype == tdt and got.shape == (b, d)
        assert_close(got, embedding_bag_ref(table, jnp.asarray(ids)), tol)
        if b * h <= 512:                       # the interpreter is slow
            assert_close(got, embedding_bag_pallas(
                table, jnp.asarray(ids), interpret=True), tol)

    @pytest.mark.parametrize("seed", range(4))
    def test_repeated_and_random_ids_f32(self, seed):
        rng = np.random.default_rng(seed)
        v, d = int(rng.integers(16, 3000)), int(rng.choice([16, 64, 128]))
        b, h = int(rng.integers(1, 300)), int(rng.integers(1, 7))
        table = rng.normal(size=(v, d)).astype(np.float32)
        ids = rng.integers(0, min(v, 8), (b, h)).astype(np.int32)
        got = tbag.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids))
        assert_close(got, embedding_bag_ref(jnp.asarray(table),
                                            jnp.asarray(ids)), 2e-5)

    def test_repeated_ids_in_bag(self):
        table = torch.from_numpy(np.eye(8, 4, dtype=np.float32))
        out = tbag.embedding_bag(table, torch.tensor([[2, 2, 2]]))
        np.testing.assert_array_equal(out[0].numpy(), 3 * np.eye(8, 4)[2])

    def test_sums_in_bag_order(self):
        """The plain version adds a bag's rows in h order in f32: the
        order the kernel adds them in."""
        rng = np.random.default_rng(3)
        table = torch.from_numpy(rng.normal(size=(50, 16))
                                 .astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, 50, (9, 5)))
        want = table[ids[:, 0]].clone()
        for h in range(1, 5):
            want = want + table[ids[:, h]]
        assert torch.equal(tbag_ref(table, ids), want)

    @pytest.mark.parametrize("h", [1, 3])
    def test_flattened_dlrm_bag_matches_jax(self, h):
        """DLRM's stacked tables [F, V, D] through one flat bag call."""
        rng = np.random.default_rng(h)
        f, v, d, b = 5, 40, 16, 11
        tables = rng.normal(size=(f, v, d)).astype(np.float32)
        ids = rng.integers(0, v, (b, f, h)).astype(np.int32)
        got = tdlrm.embedding_bag(torch.from_numpy(tables),
                                  torch.from_numpy(ids))
        want = jdlrm.embedding_bag(jnp.asarray(tables), jnp.asarray(ids))
        assert got.shape == (b, f, d)
        assert_close(got, want, 2e-5)

    def test_fields_offset_rows(self):
        table = torch.arange(12, dtype=torch.float32)[:, None]  # 3 x 4 rows
        ids = torch.tensor([[1], [1], [1], [3]])
        out = tbag.embedding_bag(table, ids, fields=3)
        np.testing.assert_array_equal(out[:, 0].numpy(), [1, 5, 9, 3])


# ---------------------------------------------------------------------------
# K5: flash attention
# ---------------------------------------------------------------------------

#: (B, S, T, KV, group, d, causal, window, dtype): GQA groups 1, 2, 4 and
#: StarCoder2's 12, S not a multiple of 128, windows 8-64, long KV
ATTN_CASES = [
    (1, 40, 40, 2, 1, 64, True, None, "f32"),
    (2, 200, 200, 1, 2, 128, True, None, "f32"),
    (1, 130, 130, 2, 4, 64, False, None, "f32"),
    (1, 77, 77, 2, 12, 128, True, None, "f32"),
    (1, 150, 150, 2, 2, 64, True, 8, "f32"),
    (1, 300, 300, 1, 4, 64, True, 64, "f32"),
    (2, 96, 96, 2, 2, 64, True, None, "bf16"),
    (1, 140, 140, 2, 12, 128, True, 33, "bf16"),
    (1, 64, 64, 4, 1, 128, False, None, "bf16"),
]


def _qkv(rng, b, s, t, kv, group, d, jdt):
    q = jnp.asarray(rng.normal(size=(b, s, kv * group, d)), jdt)
    k = jnp.asarray(rng.normal(size=(b, t, kv, d)), jdt)
    v = jnp.asarray(rng.normal(size=(b, t, kv, d)), jdt)
    return q, k, v


class TestFlashAttention:
    @pytest.mark.parametrize("case", ATTN_CASES, ids=str)
    def test_matches_jax(self, case):
        b, s, t, kv, group, d, causal, window, dt = case
        jdt, tdt, tol = DTYPES[dt]
        q, k, v = _qkv(np.random.default_rng(s + d), b, s, t, kv, group, d,
                       jdt)
        got = tfa.flash_attention(to_torch(q, tdt), to_torch(k, tdt),
                                  to_torch(v, tdt), causal=causal,
                                  sliding_window=window)
        assert got.dtype == tdt and got.shape == q.shape
        assert_close(got, attention_ref(q, k, v, causal, window), tol)
        assert_close(got, flash_attention_pallas(
            q, k, v, causal=causal, sliding_window=window, interpret=True),
            tol)

    def test_long_kv_streaming(self):
        """T = 2048 keys for S = 128 queries (the JAX suite's case)."""
        rng = np.random.default_rng(1)
        q = jnp.asarray(rng.normal(size=(1, 128, 2, 64)), jnp.float32)
        k = jnp.asarray(rng.normal(size=(1, 2048, 2, 64)) * 3, jnp.float32)
        v = jnp.asarray(rng.normal(size=(1, 2048, 2, 64)), jnp.float32)
        got = tfa.flash_attention(to_torch(q, torch.float32),
                                  to_torch(k, torch.float32),
                                  to_torch(v, torch.float32), causal=False)
        assert_close(got, attention_ref(q, k, v, causal=False), 3e-5)
        assert_close(got, flash_attention_pallas(q, k, v, causal=False,
                                                 interpret=True), 3e-5)

    @pytest.mark.parametrize("causal", [True, False])
    def test_fully_masked_rows_are_zero(self, causal):
        """T = 10 keys, S = 20 queries, window 2: query s sees keys in
        (s - 2, s], so rows s >= 11 see no key and come out as zeros, as
        from the Pallas kernel and the JAX oracle."""
        q, k, v = _qkv(np.random.default_rng(2), 1, 20, 10, 1, 2, 64,
                       jnp.float32)
        got = tfa.flash_attention(to_torch(q, torch.float32),
                                  to_torch(k, torch.float32),
                                  to_torch(v, torch.float32), causal=causal,
                                  sliding_window=2)
        assert torch.count_nonzero(got[:, 11:]) == 0
        assert torch.count_nonzero(got[:, :10]) > 0
        assert_close(got, attention_ref(q, k, v, causal, 2), 2e-5)
        assert_close(got, flash_attention_pallas(
            q, k, v, causal=causal, sliding_window=2, interpret=True), 2e-5)

    def test_query_chunks_equal_whole(self):
        rng = np.random.default_rng(4)
        q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   for sh in ((1, 100, 4, 16), (1, 100, 2, 16),
                              (1, 100, 2, 16)))
        whole = tfa_ref(q, k, v, True, 24)
        chunked = tfa_ref(q, k, v, True, 24, q_chunk=32)
        assert torch.allclose(whole, chunked, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestOnCard:
    """K4 and K5 against their plain versions on the card.  K4 adds in the
    plain version's order: equal in f32.  K5 sums in its own order: 2e-5
    relative in f32; in bf16 one bf16 ulp (2^-7 relative) at the largest
    output, since both compute in f32 and round once."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("dt", sorted(DTYPES))
    @pytest.mark.parametrize("case", BAG_CASES, ids=str)
    def test_embedding_bag_equals_plain(self, case, dt):
        from repro_torch.kernels.embedding_bag.embedding_bag import \
            embedding_bag_cuda
        v, d, b, h = case
        tdt = DTYPES[dt][1]
        rng = np.random.default_rng(v)
        table = torch.from_numpy(rng.normal(size=(2 * v, d))
                                 .astype(np.float32)).to(tdt)
        ids = torch.from_numpy(rng.integers(0, v, (b, h)).astype(np.int32))
        for fields in (1, 2):
            want = tbag_ref(table, ids, fields)
            n0 = embedding_bag_cuda.launches
            got = tbag.embedding_bag(table.cuda(), ids.cuda(), fields)
            assert embedding_bag_cuda.launches == n0 + 1
            assert torch.equal(got.cpu(), want)

    @pytest.mark.parametrize("case", ATTN_CASES, ids=str)
    def test_flash_attention_close_to_plain(self, case):
        from repro_torch.kernels.flash_attention.flash_attention import \
            flash_attention_cuda
        b, s, t, kv, group, d, causal, window, dt = case
        tdt = DTYPES[dt][1]
        rng = np.random.default_rng(s)
        q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   .to(tdt).cuda()
                   for sh in ((b, s, kv * group, d), (b, t, kv, d),
                              (b, t, kv, d)))
        want = tfa_ref(q, k, v, causal, window).float()
        n0 = flash_attention_cuda.launches
        got = tfa.flash_attention(q, k, v, causal, window).float()
        assert flash_attention_cuda.launches == n0 + 1
        scale = float(want.abs().max())
        rel = 2e-5 if tdt == torch.float32 else 2.0 ** -7
        assert float((got - want).abs().max()) <= rel * scale
