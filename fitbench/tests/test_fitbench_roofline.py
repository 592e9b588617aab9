"""The yardstick's counts at the cells' shapes, against values worked by
hand, and the trace arithmetic on a made-up timeline."""
import pytest

from fitbench import devtrace, manifest, roofline

SXM = roofline.PEAKS["H100"]
STAR = {"loss": "logistic", "tau": 0.1,
        "fit_work": {"once": ["gram", "cholesky"],
                     "per_iter": ["tri_solve", "admm_iter"]}}


def test_peaks_by_card_name():
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert roofline.peaks("NVIDIA H100 PCIe") == (2.0e12, 51e12)


def test_logistic_prox_operations_at_delta_10():
    # bracket 13, 4 bisection steps of 10, start 7, 2 Newton steps of 14,
    # 3 clamped steps of 18
    assert roofline.prox_flops(STAR) == 13 + 40 + 7 + 28 + 54


def test_k3_at_the_star_catalog():
    # 2^25 x 307 f32: D 4 m n = 41,204,842,496 B; y, lam, labels read and
    # y', lam' written: 20 m = 671,088,640 B; x in, d, w, v out: 16 n
    nbytes, flops = roofline.stage("admm_iter", 2 ** 25, 307, STAR)
    assert nbytes == 41_204_842_496 + 671_088_640 + 4_912
    # Dx and three transposed products 8 m n, the prox 142 a row
    assert flops == 82_409_684_992 + 142 * 2 ** 25
    assert roofline.floor_s(nbytes, flops, SXM) == \
        pytest.approx(41_875_936_048 / 3.35e12)          # 12.50 ms
    # a rank's quarter of the same rows
    assert roofline.stage("admm_iter", 2 ** 23, 307, STAR)[0] \
        == 10_468_987_696


def test_gram_at_the_star_catalog():
    nbytes, flops = roofline.stage("gram", 2 ** 25, 307, STAR)
    assert flops == 3_162_471_661_568                   # m n^2
    assert nbytes == 41_205_219_492                     # D, then G
    assert roofline.floor_s(nbytes, flops, SXM) == \
        pytest.approx(3_162_471_661_568 / 67e12)         # 47.20 ms


def test_whole_fit_floor():
    # two solves on the factor: 2 n^2 operations, L and x (bytes bound)
    assert roofline.stage("tri_solve", 2 ** 25, 307, STAR) == \
        (4 * 307 ** 2 + 8 * 307, 2 * 307 ** 2)
    assert roofline.stage("cholesky", 2 ** 25, 307, STAR) == \
        (8 * 307 ** 2, 307 ** 3 / 3)
    each = (4 * 307 ** 2 + 8 * 307) / 3.35e12 + 41_875_936_048 / 3.35e12
    once = 3_162_471_661_568 / 67e12 + 8 * 307 ** 2 / 3.35e12
    assert roofline.fit_floor_s(STAR, 2 ** 25, 307, 200, SXM) == \
        pytest.approx(once + 200 * each)
    assert 2.54 < roofline.fit_floor_s(STAR, 2 ** 25, 307, 200, SXM) < 2.56


@pytest.mark.parametrize("config", ["star_catalog", "star_catalog_x4"])
def test_every_stage_and_prox_of_a_configuration_has_its_file(config):
    cfg = manifest.data_file("configs", config)
    for stage in cfg["fit_work"]["once"] + cfg["fit_work"]["per_iter"]:
        assert (manifest.HERE / "work" / f"{stage}.py").is_file()
    assert (manifest.HERE / "work" / f"prox_{cfg['loss']}.py").is_file()


def test_union_and_clipping():
    merged = devtrace.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert merged == [[0, 3], [5, 9]]
    assert devtrace.clipped_total(merged, 2, 6) == 2
    assert devtrace.clipped_total(merged, 0, 10) == 7


def test_kernel_seconds_and_breakdown():
    s = {"kernels": {"void admm_ring_kernel<float>": [0.5, 10],
                     "admm_reduce_kernel": [0.1, 10],
                     "ncclDevKernel_AllGather": [0.01, 10]},
         "idle": {"fitbench.fit / python": 0.2}}
    assert devtrace.kernel_seconds(s, "admm_ring", "admm_reduce") == \
        (pytest.approx(0.6), 20)
    b = devtrace.breakdown([s, s])
    assert b["device_ops"][0] == ["void admm_ring_kernel<float>", 0.5]
    assert b["idle_gaps"] == [["fitbench.fit / python", 0.2]]
