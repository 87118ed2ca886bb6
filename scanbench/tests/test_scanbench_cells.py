"""The benchmark's cells are data: each resolves to its files, and a cell,
a mix or a metric added as files alone is picked up."""

import json
import os
import shutil

import numpy as np
import pytest

from scanbench import harness, kernels, scenes

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_workload_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert scenes.room_of(cell["config"]).objects
    assert set(cell["limits"]) == {"score_gap", "icp_gap_mm", "label_miss"}
    assert {m["name"] for m in cell["end_to_end"]} == {"rescan_s", "setup_s"}
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert harness.reader(m["name"], cell["folder"])({"rescans": []}) \
            is None


def test_files_alone_add_a_cell_a_mix_and_a_metric(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "scanbench"), root / "scanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "office.move1", "config":
                               "office-4x4-5obj", "traffic": "move1",
                               "chips": 1, "why": "one object moved"})
    bench["per_layer"].append({"name": "rescans_n", "unit": "1", "better":
                               "higher", "source": "host_clock", "layer":
                               "stages", "moves": "rescan_s",
                               "workloads": ["office.move1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.load(open(os.path.join(ROOT, "scanbench/traffic/move2.json")))
    mix["mix"]["moves"] = 1
    (root / "scanbench/traffic/move1.json").write_text(json.dumps(mix))
    shutil.copy(root / "scanbench/limits/office.move2.json",
                root / "scanbench/limits/office.move1.json")
    (root / "scanbench/metrics/rescans_n.py").write_text(
        "def read(record):\n    return len(record['rescans']) or None\n")
    cell = harness.load_cell("office.move1", root=str(root))
    assert cell["traffic"]["mix"]["moves"] == 1
    assert [m["name"] for m in cell["per_layer"]] == ["rescans_n"]
    assert harness.reader("rescans_n", cell["folder"])(
        {"rescans": [{}, {}]}) == 2
    pool = scenes.draw_pool(scenes.room_of(cell["config"]),
                            cell["traffic"], 7)
    assert len(pool) == cell["traffic"]["pool"]
    # the cells already there see nothing of it
    old = harness.load_cell("office.move2", root=str(root))
    assert "rescans_n" not in [m["name"] for m in old["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_traffic_moves_stay_in_the_room_and_apart(name):
    cell = harness.load_cell(name)
    room0 = scenes.room_of(cell["config"])
    tr = cell["traffic"]
    for pool_seed in [tr["pool_seed"], 0, 1, 2 ** 31 + 5, 2 ** 33 + 11] \
            + list(range(100, 107)):
        mix = dict(tr, pool_seed=pool_seed)
        for room in scenes.draw_pool(room0, mix, 3):
            moved = [k for k, (a, b) in
                     enumerate(zip(room0.objects, room.objects)) if a != b]
            assert len(moved) == tr["mix"]["moves"]
            for k in moved:
                # each move keeps its clearance from what stood there when
                # it was drawn; no two footprints meet
                assert scenes.fits(room, k, 0.0)
                a, b = room0.objects[k], room.objects[k]
                d = np.hypot(b.center[0] - a.center[0],
                             b.center[1] - a.center[1])
                lo, hi = tr["mix"]["distance_m"]
                assert lo - 1e-9 <= d <= hi + 1e-9
                turn = abs(np.degrees(b.rot - a.rot))
                assert tr["mix"]["turn_deg"][0] - 1e-9 <= turn \
                    <= tr["mix"]["turn_deg"][1] + 1e-9
            for k in range(len(room.objects)):
                fp = scenes.footprint(room.objects[k])
                assert fp.min() >= 0.0 and fp[:, 0].max() <= room.size[0] \
                    and fp[:, 1].max() <= room.size[1]


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_rescans_in_its_own_order(name):
    cell = harness.load_cell(name)
    room0 = scenes.room_of(cell["config"])
    runs = [scenes.draw_pool(room0, cell["traffic"], seed)
            for seed in (1, 2, 3, 2 ** 31 + 7, 2 ** 33)]
    assert all(sorted(map(repr, r)) == sorted(map(repr, runs[0]))
               for r in runs)
    assert len({tuple(map(repr, r)) for r in runs}) > 1
    assert scenes.draw_pool(room0, cell["traffic"], 2) == runs[1]


def test_kernel_byte_bounds_match_the_recorded_launches():
    # K1's scoring launch and K2's ICP launch of the bench rescan
    # (chip_smoke's bound, PERF.md's kernel table)
    assert round(kernels.gnn_bound_s("gated_min", 4194304, 300492) * 1e3,
                 5) == 0.04222
    assert round(kernels.gnn_bound_s("nearest_gated", 262144, 99290) * 1e3,
                 5) == 0.00365


def test_result_line_has_the_contracts_keys():
    cell = harness.load_cell("office.move2")
    rec = {"rescans": [{"seconds": 1.0, "pose_proposal": {"total": 0.4,
                                                          "nms": 0.1,
                                                          "grid_search": 0.1},
                        "segment_transfer": {"total": 0.6,
                                             "label_smooth": 0.2,
                                             "refine_to_scene": 0.01,
                                             "aug_icp": 0.01}}],
           "launches": [("gated_min", 10, 10), ("nearest_gated", 10, 10)],
           "n_rescans": 1, "window_s": 1.0, "busy_s": 0.5, "kernel_s":
           {"void gnn_kernel<false, false>": 1.0,
            "void gnn_kernel<true, false>": 1.0},
           "breakdown": {"device_ops": [], "idle_gaps": []}}
    out = {"record": rec, "setup_s": 2.0, "rescan_s": 1.0, "peak": 5,
           "failed": 0, "attempted": 1,
           "numbers": {"score_gap": 0.0, "icp_gap_mm": 0.0,
                       "label_miss": 0.0}}
    line = harness.result_line(cell, out, False, "card")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"rescan_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    traced = harness.result_line(cell, out, True, "card")
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["metrics"]) == {m["name"] for m in cell["per_layer"]}
    json.dumps(traced)
