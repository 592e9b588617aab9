"""Port parity for ``repro_torch.service.stats`` (``SufficientStats``, the
Cholesky rank-k up/downdate) against the JAX package on the same numpy
arrays: the stats tests of ``tests/test_service.py`` (merge of updates =
update of the union, commutativity, update + downdate round trip,
multiplicity-sensitive fingerprints, the checkpoint round trip, partial
labels, stacked right-hand sides, rank-k factor updates against a fresh
factor) with the port's (G, c) held to the reference's at 1e-5 and its
fingerprints equal to the reference's strings. The reference's pytree test
(``tree_map`` over the stats) has no counterpart: the port runs eagerly and
its stats are a plain dataclass of tensors, not a JAX pytree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gram as jgram
from repro.data.sparse import BlockCSR as JBlockCSR
from repro.service.stats import SufficientStats as JStats
from repro.service.stats import chol_downdate as j_downdate
from repro.service.stats import chol_update as j_update
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import gram as tgram
from repro_torch.data.sparse import BlockCSR
from repro_torch.service import (
    SufficientStats,
    chol_downdate,
    chol_update,
)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


def _data(m=300, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(ours.G.numpy(), np.asarray(ref.G), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(ours.c.numpy(), np.asarray(ref.c), rtol=rtol,
                               atol=atol)
    assert (ours.rows, ours.labeled_rows, ours.fingerprint) == \
        (ref.rows, ref.labeled_rows, ref.fingerprint)


def test_merge_of_updates_equals_update_of_union():
    D, b = _data()
    z = SufficientStats.zero(16, device="cpu")
    sa = z.update(_t(D[:100]), _t(b[:100]))
    sb = z.update(D[100:], b[100:])          # numpy blocks move to the CPU
    merged = sa.merge(sb)
    direct = z.update(_t(D[:100]), _t(b[:100])).update(_t(D[100:]),
                                                       _t(b[100:]))
    torch.testing.assert_close(merged.G, direct.G, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(merged.c, direct.c, rtol=1e-5, atol=1e-4)
    assert merged.rows == direct.rows == 300
    assert merged.fingerprint == direct.fingerprint
    whole = SufficientStats.from_data(_t(D), _t(b))
    torch.testing.assert_close(merged.G, whole.G, rtol=1e-4, atol=1e-3)
    # the reference, step for step
    jz = JStats.zero(16)
    jm = jz.update(jnp.asarray(D[:100]), jnp.asarray(b[:100])).merge(
        jz.update(jnp.asarray(D[100:]), jnp.asarray(b[100:])))
    _close(merged, jm)
    _close(whole, JStats.from_data(jnp.asarray(D), jnp.asarray(b)))


def test_merge_is_commutative():
    D, b = _data()
    z = SufficientStats.zero(16, device="cpu")
    sa = z.update(_t(D[:100]), _t(b[:100]))
    sb = z.update(_t(D[100:]), _t(b[100:]))
    ab, ba = sa.merge(sb), sb.merge(sa)
    torch.testing.assert_close(ab.G, ba.G, rtol=1e-6, atol=0)
    assert ab.fingerprint == ba.fingerprint


def test_update_then_downdate_roundtrip():
    D, b = _data()
    s = SufficientStats.from_data(_t(D[:200]), _t(b[:200]))
    s2 = s.update(_t(D[200:]), _t(b[200:])).downdate(_t(D[200:]),
                                                      _t(b[200:]))
    torch.testing.assert_close(s2.G, s.G, rtol=1e-4, atol=1e-3)
    assert s2.rows == s.rows and s2.labeled_rows == s.labeled_rows
    assert s2.fingerprint == s.fingerprint    # the +/- fold cancels exactly
    js = JStats.from_data(jnp.asarray(D[:200]), jnp.asarray(b[:200]))
    _close(s2, js.update(jnp.asarray(D[200:]), jnp.asarray(b[200:]))
           .downdate(jnp.asarray(D[200:]), jnp.asarray(b[200:])))


def test_fingerprint_is_multiplicity_sensitive():
    D, b = _data()
    s0 = SufficientStats.from_data(_t(D[:200]), _t(b[:200]))
    s1 = s0.update(_t(D[200:]), _t(b[200:]))
    s2 = s1.update(_t(D[200:]), _t(b[200:]))          # same block again
    assert s2.fingerprint != s0.fingerprint
    assert s2.fingerprint != s1.fingerprint


def test_sparse_blocks_fold_like_the_reference():
    """A BlockCSR folds through the host Gram and the CSC gather, and is
    fingerprinted over its index/value arrays (canonicalized to 2-D)."""
    rng = np.random.default_rng(2)
    m, n = 400, 16
    rows = np.repeat(np.arange(m), 3)
    cols = rng.integers(0, n, rows.shape[0]).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    tb = BlockCSR.from_coo(rows, cols, vals, m, n, block_m=128,
                           device="cpu")
    jb = JBlockCSR.from_coo(rows, cols, vals, m, n, block_m=128)
    s = SufficientStats.from_data(tb, _t(b))
    _close(s, JStats.from_data(jb, jnp.asarray(b)))
    z = SufficientStats.zero(n, device="cpu").update(tb, _t(b))
    assert z.fingerprint == s.fingerprint
    assert z.downdate(tb, _t(b)).fingerprint == \
        SufficientStats.zero(n, device="cpu").fingerprint


def test_stats_checkpoint_and_payload_roundtrip(tmp_path):
    D, b = _data()
    s = SufficientStats.from_data(_t(D), _t(b))
    mgr = CheckpointManager(str(tmp_path))
    s.save(mgr, step=0)
    r = SufficientStats.restore(mgr, n=16, device="cpu")
    assert torch.equal(r.G, s.G) and torch.equal(r.c, s.c)
    assert (r.rows, r.fingerprint, r.labeled_rows) == \
        (s.rows, s.fingerprint, s.labeled_rows)
    p = SufficientStats.from_payload(s.to_payload(), device="cpu")
    assert torch.equal(p.G, s.G) and p.fingerprint == s.fingerprint
    # the reference's payload and checkpoint come over too
    js = JStats.from_data(jnp.asarray(D), jnp.asarray(b))
    _close(SufficientStats.from_payload(js.to_payload(), device="cpu"), js,
           rtol=0, atol=0)
    from repro.checkpoint.manager import CheckpointManager as JManager
    js.save(JManager(str(tmp_path / "ref")), step=4)
    _close(SufficientStats.restore(CheckpointManager(str(tmp_path / "ref")),
                                   n=16, device="cpu"), js, rtol=0, atol=0)


def test_partial_labels_are_not_fully_labeled():
    D, b = _data()
    partial = SufficientStats.zero(16, device="cpu").update(
        _t(D[:200])).update(_t(D[200:]), _t(b[200:]))
    assert not partial.fully_labeled
    assert (partial.rows, partial.labeled_rows) == (300, 100)
    assert SufficientStats.from_data(_t(D), _t(b)).fully_labeled
    jp = JStats.zero(16).update(jnp.asarray(D[:200])).update(
        jnp.asarray(D[200:]), jnp.asarray(b[200:]))
    _close(partial, jp)


def test_multi_rhs_stats_single_pass():
    """from_data with stacked (m, r) rhs matches per-column reductions."""
    D, _ = _data()
    B = np.random.default_rng(7).standard_normal((300, 3)).astype(np.float32)
    s = SufficientStats.from_data(_t(D), _t(B))
    assert tuple(s.c.shape) == (16, 3)
    np.testing.assert_allclose(s.c.numpy(), D.T @ B, rtol=1e-4, atol=1e-3)
    _close(s, JStats.from_data(jnp.asarray(D), jnp.asarray(B)))


# ---------------------------------------------------------------------------
# Cholesky rank-k up/downdate
# ---------------------------------------------------------------------------

def test_rank_k_update_matches_fresh_factorization():
    D, _ = _data()
    G = _t(D.T @ D)
    L = tgram.gram_factor(G, ridge=0.1)
    B = np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32)
    L_up = chol_update(L, _t(B))
    L_fresh = tgram.gram_factor(G + _t(B.T @ B), ridge=0.1)
    torch.testing.assert_close(L_up, L_fresh, rtol=1e-5, atol=1e-5)
    assert torch.equal(L, tgram.gram_factor(G, ridge=0.1))   # L untouched
    Lj = j_update(jgram.gram_factor(jnp.asarray(D.T @ D), ridge=0.1),
                  jnp.asarray(B))
    np.testing.assert_allclose(L_up.numpy(), np.asarray(Lj), rtol=1e-5,
                               atol=1e-5)


def test_rank_k_downdate_matches_fresh_factorization():
    D, _ = _data()
    B = D[:5]
    G_full = _t(D.T @ D)
    L_full = tgram.gram_factor(G_full, ridge=0.1)
    L_down = chol_downdate(L_full, _t(B))
    L_fresh = tgram.gram_factor(G_full - _t(B.T @ B), ridge=0.1)
    torch.testing.assert_close(L_down, L_fresh, rtol=1e-4, atol=1e-4)
    Lj = j_downdate(jgram.gram_factor(jnp.asarray(D.T @ D), ridge=0.1),
                    jnp.asarray(B))
    np.testing.assert_allclose(L_down.numpy(), np.asarray(Lj), rtol=1e-4,
                               atol=1e-4)


def test_rank_1_vector_block():
    D, _ = _data()
    G = _t(D.T @ D)
    L = tgram.gram_factor(G, ridge=1.0)
    v = _t(D[0])                                   # 1-D block
    L_up = chol_update(L, v)
    L_fresh = tgram.gram_factor(G + torch.outer(v, v), ridge=1.0)
    torch.testing.assert_close(L_up, L_fresh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["width", "kind"])
def test_mismatches_raise(tmp_path, bad):
    D, b = _data()
    s = SufficientStats.from_data(_t(D), _t(b))
    if bad == "width":
        with pytest.raises(ValueError, match="width"):
            s.update(_t(D[:, :8]))
        return
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"G": s.G, "c": s.c}, extra={"kind": "other"})
    with pytest.raises(ValueError, match="sufficient_stats"):
        SufficientStats.restore(mgr, n=16, device="cpu")
