"""The yardstick's operation and byte counts against hand counts, and the
trace reduction on a hand-made trace."""
import json

import pytest

from portbench.harness import core, work
from portbench.harness.trace import Trace

MAZE = json.loads((core.BENCH_DIR / "configs" / "maze-planner-384.json").read_text())
WAN = json.loads((core.BENCH_DIR / "configs" / "wan2.1-t2v-1.3b.json").read_text())


def test_maze_block_hand_count():
    cfg = dict(d_model=4, d_ff=8, d_cond=2)
    flops, nbytes = work.maze_block(cfg, B=2, L=3)
    per_token = (2 * 4 * 12      # q, k, v
                 + 2 * 4 * 4     # out projection
                 + 2 * 4 * 8 * 2  # FFN up and down
                 + 2 * 3 * 4 * 2)  # QK^T and PV over 3 keys
    film = 2 * (2 * 2 * 8)       # two FiLM projections d_cond -> 2d, per request
    assert flops == 2 * 3 * per_token + 2 * film
    weights = (12 * 4 + 4 * 4 + 2 * 4 * 8 + 2 * 2 * 8) * 2
    assert nbytes == weights + (2 * 2 * 3 * 4 + 2 * 2) * 2


def test_maze_call_against_bench_py_arithmetic():
    """bench.py counted 15.6 GFLOP a request with 20 Stage-1 evaluations;
    the pipeline runs 19 (one per pair of timesteps)."""
    d, dff, n = 384, 1536, 12
    per_tok_layer = 4 * 2 * d * d + 2 * 2 * d * dff
    stage1 = 19 * 8 * n * (per_tok_layer + 4 * 8 * d)
    stage2 = 3 * 64 * n * (per_tok_layer + 4 * 64 * d)
    cnn, cin = 0, 1
    for c in (32, 64, 128, 128):
        cnn += 2 * 9 * cin * c * 21 * 21
        cin = c
    bench_py = stage1 + stage2 + 2 * cnn
    call = work.maze_call(MAZE, 1)
    assert work.ddim_evaluations(100, 20) == 19
    assert call["blocks"] == {8: 19 * 12, 64: 3 * 12}
    assert bench_py < call["flops"] < 1.03 * bench_py   # + FiLM, embeddings, heads


def test_wan_self_attention_hand_count():
    cfg = dict(dim=4, num_heads=2, sla_block=2, sla_topk=0.5)
    w = work.wan_self_attention(cfg, B=3, L=4)
    # 2 key blocks of 2, top-k 1: each query sees 2 keys; head dim 2
    sparse = 4 * 4 * 2 * 4          # QK^T and PV: 2 FLOPs x L x keys x d, twice
    linear = 6 * 4 * 4 * 2          # phi(k)^T v, phi(q) kv, projection: 2 L d dh each
    assert w["fwd"][0] == 3 * (sparse + linear)
    assert w["bwd"][0] == 2 * w["fwd"][0]
    assert w["fwd"][1] == 4 * 3 * 4 * 4 * 2 and w["bwd"][1] == 2 * w["fwd"][1]


def test_wan_step_flops_per_token():
    """About 2.8 GFLOP a token forward at Wan2.1-1.3B (30 blocks at dim
    1536, ffn 8960), a little more backward with a frozen base (attention
    backward is twice its forward)."""
    L = 5 * 30 * 52
    total = work.wan_step_flops(WAN, 1, L, 512, 5)
    assert 5.5e9 < total / L < 6.1e9


def test_wan_step_flops_tiny_hand_count():
    cfg = dict(dim=2, ffn_dim=4, lora_rank=1, num_layers=1, num_heads=1, sla_block=2,
               sla_topk=1.0, text_dim=3, in_dim=1, out_dim=1, patch_size=[1, 1, 1],
               freq_dim=2, frame_cond_dim=1, frame_cond_hidden=1)
    L, nt, ne = 2, 1, 1
    Lc = nt + ne
    base_tok = 2 * L * (6 * 4 + 2 * 2 * 4)
    base_ctx = 2 * Lc * 2 * 4
    lora = 6 * 2 * L * 1 * 4 + 2 * 2 * Lc * 4 + 2 * 2 * L * 6
    sa = 4 * L * 2 * 2 + 6 * L * 2 * 2
    ca = 4 * L * Lc * 2
    embed = (2 * L * 1 * 2 + 2 * (2 * 2 + 4 + 2 * 12) + 2 * nt * (6 + 4) + 2 * ne * (6 + 4)
             + 2 * ne * (1 + 3))
    head = 2 * L * 2
    fwd = base_tok + base_ctx + lora + sa + ca + embed + head
    bwd = base_tok + base_ctx + 2 * (sa + ca) + 2 * lora - 2 * L * 3 * 4 + 2 * ne * 10 + head
    assert work.wan_step_flops(cfg, 1, L, nt, ne) == fwd + bwd


def test_least_time_and_mfu():
    assert work.least_s(989e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.mfu_percent(989e12, 2.0) == pytest.approx(50.0)


def _trace():
    # two kernels inside a span on thread 1, one outside, one launched by thread 2
    device = [("k_in", 10.0, 11.0, 1), ("gemm_x", 12.0, 14.0, 2), ("k_out", 15.0, 15.5, 3),
              ("k_other_thread", 16.0, 17.0, 4)]
    launches = {1: (1.0, 1), 2: (2.0, 1), 3: (5.0, 1), 4: (2.5, 2)}
    ranges = {"pb.segment": [(0.0, 20.0, 1)], "pb.x.fwd": [(0.5, 3.0, 1)]}
    host = [("pb.segment", 0.0, 20.0, 1), ("aten::copy_", 17.0, 19.5, 1),
            ("autograd::engine::evaluate_function", 3.0, 9.0, 2)]
    return Trace(0.0, 20.0, device, ranges, launches, host)


def test_trace_spans_busy_and_idle():
    t = _trace()
    assert [op[0] for op in t.kernels_in("pb.x")] == ["k_in", "gemm_x"]
    assert t.busy_s == pytest.approx(4.5) and t.window_s == pytest.approx(20.0)
    gaps = t.idle_gaps(2)
    assert gaps[0] == ["autograd::engine::evaluate_function", pytest.approx(10.0)]
    assert gaps[1] == ["aten::copy_", pytest.approx(3.0)]
    assert t.top_ops(1) == [["gemm_x", 2.0]]


def test_per_layer_readers_on_a_trace():
    t = _trace()
    t.units["steps"] = 1
    c = core.find_cell("wan13b-p1-lora-sla")
    run = {"kind": "train", "trace": t, "cfg": WAN, "batch": 2, "tokens": 7800}
    idle = core.metric_reader(c, "device_idle.train")(run)
    assert idle == pytest.approx(100 * (1 - 4.5 / 20))
    # not a GEMM, not in a span, not an attention kernel: k_out and k_other_thread
    t.ranges["pb.self_attn.fwd"] = t.ranges.pop("pb.x.fwd")
    assert core.metric_reader(c, "elementwise_ms.train")(run) == pytest.approx(1.5e3)
