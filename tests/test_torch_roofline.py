"""Port parity for ``repro_torch.roofline.hlo``: the mirrors of
``tests/test_roofline_and_optim.py``'s three roofline tests with the
collectives given as records (the port has no HLO), the recorder on a fake
process group, the operation counter, and ``roofline_terms`` on the H100's
constants. Byte counts are exact; times to 1e-9 s."""
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

from repro.roofline.hlo import parse_collectives
from repro_torch.launch.fit_cell import fake_group
from repro_torch.roofline import hlo

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]

# tests/test_roofline_and_optim.py:16-25
HLO = """
HloModule test
  %x1 = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %p0), replica_groups=[16,16]<=[256], to_apply=%add
  %x2 = bf16[256,128]{1,0} all-gather(bf16[16,128]{1,0} %p1), replica_groups=[2,8]<=[16], dimensions={0}
  %x3 = f32[64]{0} reduce-scatter(f32[512]{0} %p2), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %x4 = (f32[32,32]{1,0}, f32[32,32]{1,0}) all-to-all(f32[32,32]{1,0} %a, f32[32,32]{1,0} %b), replica_groups=[4,2]<=[8]
  %x5 = f32[128]{0} collective-permute(f32[128]{0} %p3), source_target_pairs={{0,1}}
  %y = f32[10]{0} add(f32[10]{0} %a, f32[10]{0} %b)
"""

# the same five collectives as records (the tuple result as one array)
RECORDS = [("all-reduce", (1024, 512), torch.float32, 16),
           ("all-gather", (256, 128), torch.bfloat16, 8),
           ("reduce-scatter", (64,), torch.float32, 8),
           ("all-to-all", (2, 32, 32), torch.float32, 2),
           ("collective-permute", (128,), "f32", 1)]


def _stats():
    return hlo.stats([hlo.record(*r) for r in RECORDS])


def test_records_kinds_and_groups():
    st = _stats()
    assert [op["kind"] for op in st.ops] == [
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"]
    assert [op["group"] for op in st.ops] == [16, 8, 8, 2, 1]


def test_records_byte_accounting():
    st = _stats()
    ar = st.ops[0]
    assert ar["bytes"] == 1024 * 512 * 4
    assert ar["wire_bytes"] == int(2 * ar["bytes"] * 15 / 16)
    ag = st.ops[1]
    assert ag["bytes"] == 256 * 128 * 2
    assert ag["operand_bytes"] == ag["bytes"] // 8
    rs = st.ops[2]
    assert rs["operand_bytes"] == 512 * 4   # per-device input is the full array
    a2a = st.ops[3]
    assert a2a["bytes"] == 2 * 32 * 32 * 4  # tuple shape


def test_records_equal_the_reference_parse():
    """Every field the reference's parser gives for the HLO text, from
    the records."""
    ref = parse_collectives(HLO)
    st = _stats()
    for a, b in zip(ref.ops, st.ops, strict=True):
        assert {k: a[k] for k in a} == {k: b[k] for k in a}
    assert (ref.operand_bytes, ref.wire_bytes) == (st.operand_bytes,
                                                   st.wire_bytes)
    assert ref.by_kind() == st.by_kind()


def test_roofline_terms_bottleneck_on_h100_constants():
    t = hlo.roofline_terms(989.4e12, 100e9, 1e9)   # 1 s compute
    assert t["bottleneck"] == "compute"
    assert abs(t["compute_s"] - 1.0) < 1e-9
    t = hlo.roofline_terms(1e9, 3.35e12, 1e9)      # 1 s memory
    assert t["bottleneck"] == "memory"
    assert abs(t["memory_s"] - 1.0) < 1e-9
    t = hlo.roofline_terms(1e9, 1e9, 450e9)        # 1 s on NVLink
    assert t["bottleneck"] == "collective"
    assert abs(t["collective_s"] - 1.0) < 1e-9
    assert t["compute_fraction_of_bound"] < 0.01
    t = hlo.roofline_terms(67e12, 0, 0, peak_flops=hlo.PEAK_FP32)
    assert abs(t["compute_s"] - 1.0) < 1e-9


def test_collective_time_by_link():
    """A group within a node of 8 cards moves at NVLink's rate, one that
    spans nodes at InfiniBand's."""
    near = hlo.record("all-reduce", (1 << 20,), torch.float32, 8,
                      spans_nodes=hlo.spans_nodes(range(8)))
    far = hlo.record("all-reduce", (1 << 20,), torch.float32, 16,
                     spans_nodes=hlo.spans_nodes(range(16)))
    assert not near["spans_nodes"] and far["spans_nodes"]
    t = hlo.roofline_terms(0, 0, hlo.stats([near, far]))
    want = near["wire_bytes"] / 450e9 + far["wire_bytes"] / 50e9
    assert abs(t["collective_s"] - want) < 1e-12
    assert hlo.spans_nodes([0, 16, 32]) and not hlo.spans_nodes([8, 15])


def test_no_tpu_constant_and_one_table_of_peaks():
    """The TPU v5e numbers are gone; the smoke script reads this table."""
    values = [v for v in vars(hlo).values() if isinstance(v, float)]
    for tpu in (197e12, 819e9):
        assert tpu not in values
    assert (hlo.HBM_BW, hlo.PEAK_FP32, hlo.PEAK_FLOPS) == hlo.PEAKS["H100"]
    assert hlo.PEAKS["H100"] == (3.35e12, 67e12, 989.4e12)
    assert hlo.peaks("NVIDIA H100 80GB HBM3") == ("H100", hlo.PEAKS["H100"])
    assert hlo.peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.roofline.hlo import peaks" in smoke
    assert "PEAKS = {" not in smoke


def test_recorder_sees_each_collective_as_issued():
    """On a fake process group of 16 ranks (and a sub-group of 4), each
    wrapped ``torch.distributed`` call becomes one record of its kind,
    result shape and group; the functions are restored on exit."""
    before = dist.all_reduce
    with fake_group(16):
        sub = dist.new_group(list(range(4)))
        with hlo.CollectiveRecorder() as rec:
            dist.all_reduce(torch.zeros(10, 3))
            dist.all_gather([torch.zeros(5) for _ in range(4)],
                            torch.zeros(5), group=sub)
            dist.all_gather_into_tensor(torch.zeros(64, 2), torch.zeros(4, 2))
            dist.reduce_scatter_tensor(torch.zeros(4), torch.zeros(64))
            dist.all_to_all_single(torch.zeros(8, 2, dtype=torch.bfloat16),
                                   torch.zeros(8, 2, dtype=torch.bfloat16),
                                   group=sub)
            dist.broadcast(torch.zeros(7, dtype=torch.int64), 0)
        assert dist.all_reduce is before
    got = [(o["kind"], o["bytes"], o["group"], o["spans_nodes"])
           for o in rec.ops]
    assert got == [("all-reduce", 120, 16, True),
                   ("all-gather", 80, 4, False),
                   ("all-gather", 512, 16, True),
                   ("reduce-scatter", 16, 16, True),
                   ("all-to-all", 32, 4, False),
                   ("collective-permute", 56, 16, True)]
    assert rec.stats().wire_bytes == sum(o["wire_bytes"] for o in rec.ops)


def test_op_counter_flops_and_unfused_bytes():
    a = torch.randn(64, 32)
    b = torch.randn(32, 16)
    v = torch.randn(32)
    with hlo.OpCounter() as c:
        a @ b                     # mm: 2 m n k
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    with hlo.OpCounter() as c:
        a @ v                     # mv: 2 m n
        torch.bmm(a[None], b[None])
    assert c.flops == 2 * 64 * 32 + 2 * 64 * 32 * 16
    with hlo.OpCounter() as c:
        a.T.reshape(-1)[:5]       # a copy (the reshape) and views
        a + 1.0                   # read a, write the sum
    assert c.flops == 0
    assert c.bytes == 4 * 64 * 32 * 4


def test_op_counter_stands_in_for_bincount_on_meta():
    ids = torch.empty(100, dtype=torch.long, device="meta")
    with hlo.OpCounter():
        out = torch.bincount(ids, minlength=12)
    assert out.shape == (12,) and out.device.type == "meta"
    with pytest.raises(NotImplementedError):
        torch.bincount(ids, minlength=12)
