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
    (1, 200, 200, 1, 2, 64, True, 100, "bf16"),
    (1, 130, 300, 2, 2, 128, False, None, "bf16"),
]
#: bf16 cases for the tensor-core kernel's 128 × 128 tiles (on the card
#: only): windows at 4096 and one either side where they bind, S and T not
#: multiples of 128, G = 12 at d 128, T > S without the causal mask
ATTN_TILE_CASES = [
    (1, 4500, 4500, 1, 2, 128, True, 4095),
    (1, 4500, 4500, 1, 2, 128, True, 4096),
    (1, 4500, 4500, 1, 2, 128, True, 4097),
    (1, 1000, 1000, 2, 2, 64, True, 100),
    (1, 333, 333, 2, 12, 128, True, None),
    (2, 200, 700, 2, 2, 128, False, None),
    (1, 300, 1100, 1, 4, 64, False, 256),
]


#: mask probes (S, d, W), small shapes and the card's tile shapes: each is
#: run causal under windows W - 1, W and W + 1, and causal and not without
#: a window
PROBE_CASES = [(300, 64, 128), (400, 128, 200), (300, 64, 8)]
PROBE_TILE_CASES = [(4500, 128, 4096), (1000, 64, 100), (333, 128, 128)]
PROBE_RUNS = [("W-1", True), ("W", True), ("W+1", True), (None, True),
              (None, False)]


def _mask_probe(s, d, window, group=2):
    """q [1, S, group, d], k and v [1, S, 1, d] (f32 numpy) that make a
    mask's edge show in every row: query i scores its target key 12 logits
    above the keys one either side (more further off); the target is
    i - window (just outside the window) where the window binds, else i + 1
    (just past the diagonal).  v is one-hot by key position (mod d), so a
    row is the one-hot of its top admitted key."""
    f = d // 2
    theta = 0.5 * (1.0 / (4 * s)) ** (np.arange(f) / (f - 1))
    amp = np.sqrt(12.0 * np.sqrt(d) / np.sum(1 - np.cos(theta)))

    def phi(x):
        a = np.asarray(x, np.float64)[:, None] * theta
        return amp * np.concatenate([np.cos(a), np.sin(a)], 1)

    i = np.arange(s)
    target = np.where(i >= window, i - window, i + 1)
    q = np.broadcast_to(phi(target)[None, :, None], (1, s, group, d))
    k = phi(i)[None, :, None]
    v = np.zeros((1, s, 1, d))
    v[0, i, 0, i % d] = 1.0
    return [np.ascontiguousarray(x, np.float32) for x in (q, k, v)]


def _probe_window(w, name):
    return None if name is None else w + {"W-1": -1, "W": 0, "W+1": 1}[name]


def _row_rel(got, want):
    """Max over rows (one query and head) of a row's max abs error over
    that row's max |plain|; a row the plain version leaves zero must be
    zero."""
    err = (got - want).abs().flatten(0, -2).amax(-1)
    scale = want.abs().flatten(0, -2).amax(-1)
    assert (err[scale == 0] == 0).all()
    return float((err / scale.clamp_min(1e-30))[scale > 0].max())


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

    @pytest.mark.parametrize("run", PROBE_RUNS, ids=str)
    @pytest.mark.parametrize("case", PROBE_CASES, ids=str)
    def test_mask_probe_matches_jax(self, case, run):
        """On the mask probe every row is one key's one-hot, so a mask one
        key off at its edge moves the row by about 1, far outside 2e-5."""
        s, d, w = case
        window, causal = _probe_window(w, run[0]), run[1]
        q, k, v = _mask_probe(s, d, w)
        got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, sliding_window=window)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        assert_close(got, attention_ref(jq, jk, jv, causal, window), 2e-5)
        assert_close(got, flash_attention_pallas(
            jq, jk, jv, causal=causal, sliding_window=window,
            interpret=True), 2e-5)

    @pytest.mark.parametrize("case", PROBE_CASES + PROBE_TILE_CASES,
                             ids=str)
    def test_mask_probe_bites(self, case):
        """Windows W - 1, W and W + 1 differ by about 1 on every row where
        they bind, and causal and not on every row that probes the
        diagonal: the probe tells them apart."""
        s, d, w = case
        q, k, v = map(torch.from_numpy, _mask_probe(s, d, w))
        out = {run: tfa_ref(q, k, v, run[1], _probe_window(w, run[0]),
                            q_chunk=512) for run in PROBE_RUNS}

        def moved(a, b, rows):
            return float((out[a][:, rows] - out[b][:, rows]).abs()
                         .amax(-1).min())

        runs = PROBE_RUNS[:3]
        for a, b in zip(runs, runs[1:] + runs[:1]):
            assert moved(a, b, slice(w + 1, None)) > 0.99
        assert moved(PROBE_RUNS[3], PROBE_RUNS[4], slice(0, w)) > 0.99

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
    relative in f32; in bf16 one bf16 ulp (2^-7 relative) of a row's
    largest output, since both compute in f32 and round once."""

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
        rel = 2e-5 if tdt == torch.float32 else 2.0 ** -7
        assert _row_rel(got, want) <= rel

    @pytest.mark.parametrize("case", ATTN_TILE_CASES, ids=str)
    def test_flash_attention_tiles_close_to_plain(self, case):
        from repro_torch.kernels.flash_attention.flash_attention import \
            flash_attention_cuda
        b, s, t, kv, group, d, causal, window = case
        rng = np.random.default_rng(t)
        q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   .to(torch.bfloat16).cuda()
                   for sh in ((b, s, kv * group, d), (b, t, kv, d),
                              (b, t, kv, d)))
        want = tfa_ref(q, k, v, causal, window).float()
        n0 = flash_attention_cuda.launches
        got = tfa.flash_attention(q, k, v, causal, window).float()
        assert flash_attention_cuda.launches == n0 + 1
        assert _row_rel(got, want) <= 2.0 ** -7

    @pytest.mark.parametrize("dt", sorted(DTYPES))
    @pytest.mark.parametrize("case", PROBE_TILE_CASES, ids=str)
    def test_flash_attention_mask_probe(self, case, dt):
        """The mask probe at the tensor-core kernel's tile shapes: a mask
        one key off at its edge would move a row by about 1."""
        from repro_torch.kernels.flash_attention.flash_attention import \
            flash_attention_cuda
        s, d, w = case
        tdt = DTYPES[dt][1]
        q, k, v = (torch.from_numpy(x).to(tdt).cuda()
                   for x in _mask_probe(s, d, w))
        rel = 2e-5 if tdt == torch.float32 else 2.0 ** -7
        for name, causal in PROBE_RUNS:
            window = _probe_window(w, name)
            want = tfa_ref(q, k, v, causal, window, q_chunk=512).float()
            n0 = flash_attention_cuda.launches
            got = tfa.flash_attention(q, k, v, causal, window).float()
            assert flash_attention_cuda.launches == n0 + 1
            assert _row_rel(got, want) <= rel, (name, causal)
