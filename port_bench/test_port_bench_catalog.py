"""The harness finds a cell's parts by name, each a file of its own, and
BENCHMARK.json names only parts that are there."""
import json

import pytest

from port_bench import catalog, testing, train_check

BENCH = json.loads((catalog.ROOT.parent / "BENCHMARK.json").read_text())


def test_a_dummy_configuration_traffic_and_metric_are_found_by_name(
        tmp_path):
    """Adding a cell or a metric is adding files: nothing that is there is
    edited."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "dummy-model.json").write_text(
        json.dumps({"name": "dummy-model", "model": {"d_model": 8}}))
    (tmp_path / "traffic" / "dummy.mix.json").write_text(
        json.dumps({"name": "dummy.mix", "kind": "lora_train"}))
    (tmp_path / "metrics" / "dummy.share.py").write_text(
        "UNIT = '%'\nLAYER = 'dummy'\nMOVES = 'train_tokens_per_s'\n\n"
        "def read(s):\n    return 100.0 * s['busy_s'] / s['window_s']\n")
    assert catalog.config("dummy-model", tmp_path)["model"] == {"d_model": 8}
    assert catalog.traffic("dummy.mix", tmp_path)["kind"] == "lora_train"
    m = catalog.metric("dummy.share", tmp_path)
    assert m.read({"busy_s": 1.0, "window_s": 4.0}) == 25.0
    with pytest.raises(FileNotFoundError):
        catalog.metric("absent", tmp_path)


def test_the_tiny_cells_resolve_through_the_run_path(tmp_path):
    from port_bench import run

    bench = testing.make_catalog(tmp_path)
    ctx = run.resolve(bench, "tiny.moe", tmp_path)
    assert ctx.model["name"] == "tiny-moe"
    assert set(ctx.per_layer) == {"mfu.train", "idle_pct.train"}
    assert ctx.driver.run


def test_every_benchmark_entry_has_its_files():
    for conf in BENCH["configs"]:
        data = catalog.config(conf["name"])
        assert data["name"] == conf["name"]
        assert conf["file"] == f"port_bench/configs/{conf['name']}.json"
        assert sorted(data["reduced"]) == sorted(conf["reduced"])
        catalog.reference(data["model"]["arch_type"])
    for w in BENCH["workloads"]:
        t = catalog.traffic(w["traffic"])
        catalog.driver(t["kind"])
        cell = catalog.cell(w["name"])
        conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        numbers = set(train_check.NUMBERS)
        if not catalog.config(conf["name"])["model"].get("moe"):
            numbers.discard("route_gap")
        assert cell["limits"] and set(cell["limits"]) | set(
            cell.get("not_compared", {})) == numbers
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        reader = catalog.metric(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
            m["unit"], m["layer"], m["moves"])
        assert m["moves"] in e2e


def test_the_configs_hold_the_published_widths():
    """Only the depth of Mixtral-8x22B is cut; Mamba-2 370M is whole."""
    mix = catalog.config("mixtral-8x22b-l8")
    pub, m = mix["published"], mix["model"]
    assert (m["d_model"], m["num_heads"], m["num_kv_heads"], m["d_ff"],
            m["vocab_size"], m["moe"]["num_experts"], m["moe"]["top_k"]) == (
        pub["hidden_size"], pub["num_attention_heads"],
        pub["num_key_value_heads"], pub["intermediate_size"],
        pub["vocab_size"], pub["num_local_experts"],
        pub["num_experts_per_tok"])
    assert m["sliding_window"] is pub["sliding_window"] is None
    assert m["num_layers"] == 8 < pub["num_hidden_layers"]
    mamba = catalog.config("mamba2-370m")
    pub, m = mamba["published"], mamba["model"]
    assert (m["num_layers"], m["d_model"], m["ssm"]["state_size"],
            m["ssm"]["head_dim"], m["ssm"]["expand"]) == (
        pub["n_layer"], pub["d_model"], pub["d_state"], pub["headdim"],
        pub["expand"])
    pad = pub["pad_vocab_size_multiple"]
    assert m["vocab_size"] == -(-pub["vocab_size"] // pad) * pad
    assert set(mamba["changed"]) == set(mamba["reduced"])
