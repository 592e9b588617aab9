"""Port parity for ``repro_torch.cluster.compress`` against
``repro.cluster.compress``: the blockwise int8 quantizer, its inverse, the
error-feedback step and the wire-byte count give the reference's values
bit for bit on the same numpy inputs."""
import jax

jax.config.update("jax_platform_name", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.cluster import compress as jc  # noqa: E402
from repro_torch.cluster import compress as tc  # noqa: E402

SIZES = (1, 20, 256, 257, 307, 1000)


def _vec(n, seed):
    """Entries over several decades, signs mixed, one exact zero."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
    v[n // 2] = 0.0
    return v.astype(np.float32)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("n", SIZES)
def test_quantize_dequantize_bitwise(n):
    v = _vec(n, n)
    jq, js = jc.quantize_int8(jnp.asarray(v))
    tq, ts = tc.quantize_int8(torch.from_numpy(v))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape
    _same(tq.numpy(), jq)
    _same(ts.numpy(), js)
    _same(tc.dequantize_int8(tq, ts, n).numpy(),
          jc.dequantize_int8(jq, js, n))
    # a smaller block: more groups, each with its own scale
    jq, js = jc.quantize_int8(jnp.asarray(v), block=16)
    tq, ts = tc.quantize_int8(torch.from_numpy(v), block=16)
    _same(tq.numpy(), jq)
    _same(ts.numpy(), js)


def test_round_half_to_even_and_scale_floor():
    """Both packages round halves to even (127 / 127 = scale 1, so the
    codes are the rounded entries), and an all-zero group takes the 1e-30
    scale floor."""
    v = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5],
                 dtype=np.float32)
    tq, ts = tc.quantize_int8(torch.from_numpy(v))
    assert tq.tolist() == [[127, 0, 2, 2, 0, -2, 4, -4]]
    _same(tq.numpy(), jc.quantize_int8(jnp.asarray(v))[0])
    z = np.zeros(8, np.float32)
    tq, ts = tc.quantize_int8(torch.from_numpy(z), block=4)
    jq, js = jc.quantize_int8(jnp.asarray(z), block=4)
    _same(ts.numpy(), js)
    assert float(ts[0, 0]) == np.float32(1e-30) and not tq.any()


@pytest.mark.parametrize("n", (20, 307, 1000))
def test_error_feedback_carry_five_steps(n):
    """Five EF steps, each quantizing v_t + err_{t-1}: the codes, scales and
    carried residuals agree bit for bit, and the reconstructions sum to the
    inputs less the last residual."""
    jerr = jnp.zeros(n, jnp.float32)
    terr = torch.zeros(n)
    total_v = np.zeros(n, np.float64)
    total_deq = np.zeros(n, np.float64)
    for t in range(5):
        v = _vec(n, 100 * n + t)
        jq, js, jerr = jc.ef_compress(jnp.asarray(v), jerr)
        tq, ts, terr = tc.ef_compress(torch.from_numpy(v), terr)
        _same(tq.numpy(), jq)
        _same(ts.numpy(), js)
        _same(terr.numpy(), jerr)
        total_v += v
        total_deq += tc.dequantize_int8(tq, ts, n).double().numpy()
    np.testing.assert_allclose(total_deq + terr.double().numpy(), total_v,
                               rtol=1e-5, atol=1e-5 * np.abs(total_v).max())


def test_wire_bytes():
    for n in SIZES + (0, 32, 4096):
        for compressed in (False, True):
            for block in (16, 256):
                assert tc.wire_bytes(n, compressed, block) == \
                    jc.wire_bytes(n, compressed, block)
    assert tc.wire_bytes(307, True) == 2 * 256 + 8 < tc.wire_bytes(307, False)
