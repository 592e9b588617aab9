"""Port parity for the out-of-core store: ``repro_torch.data.store`` (the
copy of ``repro/data/store.py``) and ``engine.autotune.streaming_block_rows``
against the JAX package on the same numpy arrays — the store contract of
``tests/test_streaming.py`` (blocks, padding, the mmap round trip) plus
equality with the reference: the same fingerprint STRINGS for dense and
sparse stores, stores saved by either package open in the other, and the
same block heights."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import sparse as jsparse
from repro.data.store import ShardedMatrixStore as JStore
from repro.engine import autotune as jautotune
from repro_torch.data import sparse as tsparse
from repro_torch.data.sparse import BlockCSR
from repro_torch.data.store import ShardedMatrixStore, fingerprint_array
from repro_torch.engine import autotune
from repro_torch.service.stats import SufficientStats

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def flat():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((1200, 24)).astype(np.float32)
    a = np.sign(rng.standard_normal(1200)).astype(np.float32)
    return D, a


def test_store_blocks_and_padding(flat):
    D, a = flat                                # m = 1200
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=512)
    assert (store.m, store.n, store.nblocks) == (1200, 24, 3)
    Dt, at = store.block(2, padded=False)
    assert Dt.shape == (176, 24) and at.shape == (176,)
    Dp, ap = store.block(2, padded=True)
    assert Dp.shape == (512, 24) and ap.shape == (512,)
    assert np.all(Dp[176:] == 0) and np.all(ap[176:] == 0)
    np.testing.assert_array_equal(Dp[:176], Dt)
    sls = [store.block_slice(k) for k in range(store.nblocks)]
    assert sls[0] == slice(0, 512) and sls[2] == slice(1024, 1200)
    np.testing.assert_array_equal(
        np.concatenate([store.block(k)[0] for k in range(3)]), D)
    # tensors go in as their numpy arrays (node-stacked too)
    st2 = ShardedMatrixStore.from_arrays(torch.from_numpy(D).reshape(4, 300,
                                                                     24),
                                         torch.from_numpy(a),
                                         block_rows=512)
    assert st2.fingerprints == store.fingerprints


@pytest.mark.parametrize("labeled", [True, False])
def test_store_fingerprints_equal_reference_strings(flat, labeled):
    D, a = flat
    aux = a if labeled else None
    ours = ShardedMatrixStore.from_arrays(D, aux, block_rows=500)
    ref = JStore.from_arrays(D, aux, block_rows=500)
    assert ours.fingerprints == ref.fingerprints
    assert ours.fingerprint == ref.fingerprint
    for k in range(ours.nblocks):
        Db, ab = ours.block(k, padded=False)
        assert ours.fingerprints[k] == fingerprint_array(Db, ab)
        assert ours.verify_block(k)
    assert ours.verify_blocks(range(ours.nblocks)) == []
    # stats from the store fold the same fingerprints, at the reference's
    # (G, c) within 1e-5
    s = SufficientStats.from_store(ours, device="cpu")
    assert s.fingerprint == ours.fingerprint
    assert s.rows == ours.m and s.labeled_rows == (ours.m if labeled else 0)
    from repro.service.stats import SufficientStats as JStats
    js = JStats.from_store(ref)
    np.testing.assert_allclose(s.G.numpy(), np.asarray(js.G), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(s.c.numpy(), np.asarray(js.c), rtol=1e-5,
                               atol=1e-3)


def test_sparse_store_fingerprints_equal_reference_strings():
    rng = np.random.default_rng(3)
    m, n = 1000, 40
    rows = np.repeat(np.arange(m), 3)
    cols = rng.integers(0, n, rows.shape[0]).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    aux = np.sign(rng.standard_normal(m)).astype(np.float32)
    tb = BlockCSR.from_coo(rows, cols, vals, m, n, block_m=256,
                           device="cpu")
    jb = jsparse.BlockCSR.from_coo(rows, cols, vals, m, n, block_m=256)
    ours = ShardedMatrixStore.from_sparse(tb, aux)
    ref = JStore.from_sparse(jb, aux)
    assert ours.sparse_meta == ref.sparse_meta
    assert ours.fingerprints == ref.fingerprints
    assert ours.fingerprint == ref.fingerprint
    assert ours.nbytes == ref.nbytes and ours.block_rows == 256
    # a one-block BlockCSR per block, tail logically short unless padded
    Bt, at = ours.block(3, padded=False)
    assert isinstance(Bt, BlockCSR) and Bt.shape == (232, n)
    assert at.shape == (232,)
    Bp, ap = ours.block(3, padded=True)
    assert Bp.shape == (256, n) and ap.shape == (256,)
    np.testing.assert_array_equal(
        Bp.to_dense()[:232].numpy(),
        tb.to_dense().numpy()[768:])
    assert all(ours.verify_block(k) for k in range(ours.nblocks))
    with pytest.raises(TypeError, match="bfloat16"):
        tsparse.host_blocks(tb.astype(torch.bfloat16))


def test_store_mmap_roundtrip_and_cross_package(tmp_path, flat):
    D, a = flat
    ram = ShardedMatrixStore.from_arrays(D, a, block_rows=256)
    disk = ShardedMatrixStore.open(ram.save(str(tmp_path / "ours")))
    assert disk.path is not None
    assert (disk.m, disk.n, disk.block_rows) == (ram.m, ram.n, 256)
    assert disk.fingerprints == ram.fingerprints
    for k in range(ram.nblocks):
        np.testing.assert_array_equal(disk.block(k)[0], ram.block(k)[0])
        np.testing.assert_array_equal(disk.block(k)[1], ram.block(k)[1])
        assert disk.verify_block(k)
    # either package opens the other's store
    jdisk = JStore.open(str(tmp_path / "ours"))
    assert jdisk.fingerprints == ram.fingerprints
    JStore.from_arrays(D, a, block_rows=256).save(str(tmp_path / "ref"))
    mine = ShardedMatrixStore.open(str(tmp_path / "ref"))
    assert mine.fingerprints == ram.fingerprints
    np.testing.assert_array_equal(mine.block(4, padded=True)[0],
                                  ram.block(4, padded=True)[0])
    # a torn block fails its re-hash
    raw = np.load(tmp_path / "ours" / "block_000001.npy")
    raw[0, 0] += 1.0
    np.save(tmp_path / "ours" / "block_000001.npy", raw)
    torn = ShardedMatrixStore.open(str(tmp_path / "ours"))
    assert torn.verify_blocks(range(torn.nblocks)) == [1]


def test_store_open_refuses_a_dtype_numpy_cannot_name(tmp_path, flat):
    """A bfloat16 store (the reference can write one through ml_dtypes)
    opened where numpy has no bfloat16: a clear error, not garbage. Run in
    a process that imports only the store (no JAX, so no ml_dtypes)."""
    D, a = flat
    path = ShardedMatrixStore.from_arrays(D, a, block_rows=600).save(
        str(tmp_path / "st"))
    meta_path = Path(path) / "store_meta.json"
    meta = json.loads(meta_path.read_text())
    meta["dtype"] = "bfloat16"
    meta_path.write_text(json.dumps(meta))
    code = (
        "import sys\n"
        "from repro_torch.data.store import ShardedMatrixStore\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "try:\n"
        f"    ShardedMatrixStore.open({path!r})\n"
        "except TypeError as e:\n"
        "    print('REFUSED', e)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "REFUSED" in out.stdout and "bfloat16" in out.stdout


@pytest.mark.parametrize("m,n,dtype,budget", [
    (1 << 18, 512, "float32", 8 << 20),
    (100, 8, "float32", None),
    (1200, 24, "float32", 16 << 10),
    (16_777_216, 307, "float32", 4096 << 20),
    (1 << 20, 200, "float64", 512 << 20),
    (5000, 4096, "float32", 1 << 20),
])
def test_streaming_block_rows_equal_reference(m, n, dtype, budget):
    br = autotune.streaming_block_rows(m, n, np.dtype(dtype),
                                       budget_bytes=budget)
    assert br == jautotune.streaming_block_rows(m, n, np.dtype(dtype),
                                                budget_bytes=budget)
    # torch dtypes key the same height
    assert br == autotune.streaming_block_rows(m, n, getattr(torch, dtype),
                                               budget_bytes=budget)
    assert br % 8 == 0 and br <= -(-m // 8) * 8
    if budget and br >= 128:
        # the worst-case in-flight set: four D blocks and six vectors
        assert 4 * br * n * np.dtype(dtype).itemsize + 24 * br <= budget
    if (m, n) == (16_777_216, 307):
        assert br == 870_128 and -(-m // br) == 20
