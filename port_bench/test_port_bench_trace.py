"""The trace reader's classifier and the metric readers on a canned
profile: one traced step of a one-layer Mixtral-style model."""
import pytest

from port_bench import catalog, trace, yardstick

US = 1000       # ns

MODEL = {"arch_type": "moe", "num_layers": 1, "d_model": 8, "num_heads": 2,
         "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 32,
         "causal": True, "sliding_window": None,
         "moe": {"num_experts": 4, "top_k": 2},
         "lora": {"rank": 2, "targets": ["q", "o"]}}
TRAFFIC = {"batch": 2, "seq_len": 3}


def _canned():
    """(kernels, spans, host): K2 forward x4 (q, o and their recompute),
    K2 dx x1 (o; layer 0's q takes none) with its W^T copy, K3 forward x2,
    K3's backward (three kernels), the MoE experts' bmm inside its range, a
    cuBLAS product and a norm outside any range; a 10 us gap while the host
    waits in a synchronize."""
    t, kernels, spans = 0, [], []

    def k(name, dur=10):
        nonlocal t
        kernels.append((t * US, (t + dur) * US, name))
        t += dur

    def span(name, *names):
        nonlocal t
        a = t
        for n in names:
            k(n)
        spans.append((a * US, t * US, name))

    k2 = ("void (anonymous namespace)::lora_prefill_kernel<16>("
          "__nv_bfloat16 const*, __nv_bfloat16*, int)")
    for _ in range(2):
        k(k2)
        k(k2)
        k("void (anonymous namespace)::flash_fwd_bf16_kernel<128, true>("
          "Args)")
        span("moe experts", "sm90_xmma_gemm_bf16", "nvjet_hsh_64x8")
    k("vectorized_elementwise_kernel<rms>", 20)
    k("sm90_xmma_gemm_bf16f32_head", 30)
    span("K2 backward W transpose", "elementwise_kernel<copy>")
    span("K2 backward dx", "elementwise_kernel<copy_b>", "lora_prefill_kernel")
    span("K3 backward", "bwd_rowsum", "bwd_kv_bf16_kernel",
         "bwd_q_bf16_kernel")
    t += 10                       # idle
    k("Memset (Device)")
    host = [(-5 * US, (t + 5) * US, trace.WINDOW_RANGE),
            (-5 * US, 5 * US, trace.STEP_RANGE),
            ((t - 20) * US, (t - 10) * US, "cudaStreamSynchronize")]
    return kernels, spans, host


def test_each_kernel_takes_one_class():
    s = trace.summarize(*_canned(), steps=1)
    c = s["class_s"]
    assert c["lora"] == pytest.approx(7 * 10e-6)      # 4 + copy + copy_b + dx
    assert c["attention"] == pytest.approx(5 * 10e-6)  # 2 forward + 3
    assert c["moe"] == pytest.approx(4 * 10e-6)
    assert c["gemm"] == pytest.approx(30e-6)
    assert c["elementwise"] == pytest.approx(30e-6)    # rms, memset
    assert c["ssd"] == 0
    assert s["busy_s"] == pytest.approx(sum(c.values()))
    assert s["window_s"] == pytest.approx(s["busy_s"] + 20e-6)
    assert s["named"] == {"lora_|": 4, "lora_|K2 backward dx": 1,
                          "flash_fwd_|": 2}
    assert s["range_spans"]["K3 backward"] == 1
    assert s["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert s["idle_gaps"][0][1] == pytest.approx(10e-6)


def test_metric_readers_on_the_canned_step():
    s = trace.summarize(*_canned(), steps=1)
    s.update(model=MODEL, traffic=TRAFFIC)
    read = {m: catalog.metric(m).read(s) for m in
            ("mfu.train", "idle_pct.train", "elementwise_ms_per_step",
             "moe_ms_per_step", "roofline_pct.lora_matmul",
             "roofline_pct.attention", "roofline_pct.ssd_scan")}
    assert read["idle_pct.train"] == pytest.approx(
        100 * 20e-6 / s["window_s"])
    assert read["elementwise_ms_per_step"] == pytest.approx(0.030)
    assert read["moe_ms_per_step"] == pytest.approx(0.040)
    assert read["mfu.train"] == pytest.approx(
        100 * yardstick.useful_flops(MODEL, TRAFFIC)
        / (s["window_s"] * 989e12))
    k2 = sum(n * yardstick.k2_bound_s(*x)
             for *x, n in yardstick.k2_launches(MODEL, TRAFFIC))
    assert read["roofline_pct.lora_matmul"] == pytest.approx(
        100 * k2 / 70e-6)
    fwd, bwd = yardstick.k3_bounds_s(MODEL, TRAFFIC)
    assert read["roofline_pct.attention"] == pytest.approx(
        100 * (2 * fwd + bwd) / 50e-6)
    assert read["roofline_pct.ssd_scan"] is None


def test_a_roofline_is_silent_on_another_launch_count():
    kernels, spans, host = _canned()
    kernels = [k for k in kernels if "flash_fwd_" not in k[2]]
    s = trace.summarize(kernels, spans, host, steps=1)
    s.update(model=MODEL, traffic=TRAFFIC)
    assert catalog.metric("roofline_pct.attention").read(s) is None


def test_base_names():
    assert trace.base_name("void (anonymous namespace)::lora_prefill_kernel"
                           "<16>(__nv_bfloat16 const*, int)") == \
        "lora_prefill_kernel"
    assert trace.base_name("void at::native::elementwise_kernel<128, 4>(int)"
                           ) == "elementwise_kernel"
    assert trace.base_name("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN") == \
        "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"
    assert trace.base_name("Memset (Device)") == "Memset "


def test_the_step_count_must_match():
    with pytest.raises(ValueError):
        trace.summarize(*_canned(), steps=2)
