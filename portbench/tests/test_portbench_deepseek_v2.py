"""The DeepSeek-V2 family: found by its architecture, its counts on
hand-worked shapes, its kernel classes on the names the card's trace
gives, its weight tree in the port's layout, and the tiny cell judged
correct on the CPU with the fp8 control far above the program."""

import time

import pytest
import torch

from portbench import registry, run, trace, weights
from portbench.families import deepseek_v2 as fam

from . import _tiny

SEED = 2 ** 31 + 9


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(**kw):
    c = _tiny.config("deepseek-v2-lite-bf16")
    c.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
             n_routed_experts=8, num_experts_per_tok=2, head_dim=16)
    c.update(kw)
    return c


def test_registry_finds_the_family():
    c = registry.config(registry.load_benchmark(), "deepseek-v2-lite-bf16")
    assert c["architectures"] == ["DeepseekV2ForCausalLM"]
    found = registry.family(c)
    assert found.ARCHITECTURES == fam.ARCHITECTURES
    assert [k for k, _ in found.KERNEL_CLASSES] == ["MLA", "MoE"]
    assert found.reference.__name__.endswith("reference.deepseek_v2")
    # the published widths, whole
    assert (c["num_hidden_layers"], c["n_routed_experts"], c["vocab_size"],
            c["kv_lora_rank"] + c["qk_rope_head_dim"]) == (27, 64, 102400, 576)


def test_counts_on_hand_worked_shapes():
    c = _config()
    # per token: attention 64*4*32 + 64*48 + 32*4*32 + 4*16*64 a layer,
    # the dense MLP 3*64*96 once, an expert layer 64*8 + 3*64*32*2 (top-2)
    # + 3*64*32*2 (shared) twice; the head 64*512
    attn, dense, moe, head = 19456, 18432, 25088, 32768
    per_token = 3 * attn + dense + 2 * moe
    # streams at 40 and 100 with 8 and 3 valid tokens: visible pairs
    # 41 + .. + 48 and 101 + 102 + 103
    pairs = 356 + 306
    assert fam.forward_flops(c, [8, 0, 3], [40, 0, 100], 2) == \
        2 * per_token * 11 + 2 * 4 * (32 + 16) * 3 * pairs + 2 * head * 2
    calls = fam.kernel_calls(c, [40, 100], 8)
    # MLA: 2 * 4 heads * (48 + 32) a pair over 41..48 and 101..108; the
    # latent rows of 48 + 108 slots, q (48) and out (32) of 2 * 8 * 4 rows
    f, b, layers = calls["MLA"]
    assert (f, b, layers) == (2 * 4 * 80 * (356 + 836),
                              2 * 156 * 48 + 2 * 2 * 8 * 4 * 80, 3)
    # MoE: 16 tokens, 2 experts each, 3 * 64 * 32 weights an expert; the
    # expected distinct experts of 16 uniform draws of 2 from 8
    f, b, layers = calls["MoE"]
    assert f == 2 * 3 * 64 * 32 * 2 * 16 and layers == 2
    assert b == pytest.approx(3 * 64 * 32 * 2 * 8 * (1 - 0.75 ** 16))


def test_kernel_classes_match_the_cards_names():
    classes = fam.KERNEL_CLASSES
    assert trace.classify("(anonymous namespace)::mla_paged_kernel(__nv_"
                          "bfloat16 const*, int const*)", classes) == "MLA"
    assert trace.classify("(anonymous namespace)::mla_merge_kernel(float "
                          "const*)", classes) == "MLA"
    grouped = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel"
               "_for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblem"
               "ShapeIN4cute5tupleIJiiiEEEEENS5_10collec")
    assert trace.classify(grouped, classes) == "MoE"
    assert trace.classify(grouped) == "matmul"
    assert trace.classify("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNN",
                          classes) == "matmul"


def test_weight_tree_has_the_ports_layout():
    c = _config()
    p = weights.make(fam, c, SEED, "cpu")["llama"]
    L, D, E = 3, 64, 8
    assert p["layers"]["wq"].shape == (L, D, 4 * 32)
    assert p["layers"]["wkv_a"].shape == (L, D, 48)
    assert p["layers"]["wkv_b"].shape == (L, 32, 4 * 32)
    assert p["dense"]["w_gate"].shape == (1, D, 96)
    assert p["moe"]["w_gate_up"].shape == (L - 1, E, D, 64)
    assert p["moe"]["w_down"].shape == (L - 1, E, 32, D)
    assert p["moe"]["s_down"].shape == (L - 1, 64, D)
    assert all(t.dtype == torch.float32 for t in p["layers"].values())
    again = weights.make(fam, c, SEED, "cpu")["llama"]
    assert torch.equal(p["moe"]["w_gate_up"], again["moe"]["w_gate_up"])


def test_tiny_cell_is_correct_and_the_control_is_not():
    b = _tiny.bench("tiny.ds", "deepseek-v2-lite-bf16", "narrate64",
                    "deepseek-v2-lite-bf16.narrate64")
    outs = [run.run_cell("tiny.ds", SEED, 1.0, False, device="cpu", bench=b,
                         config=_config(), mix=_tiny.serve_mix(streams=2),
                         control=control, t0=time.perf_counter())
            for control in (False, True)]
    assert outs[0]["correct"] and outs[0]["checks"]["mean_gap"]["value"] < 1e-4
    st = outs[1]["_stats"]
    assert st["control_mean_gap"] > 3 * st["mean_gap"]
    assert st["control_gate_gap"] > 3 * st["gate_gap"]
