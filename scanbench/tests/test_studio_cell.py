"""The studio cell (studio.move4all) resolves to its files, its pool draws,
and its scan is large enough that the scoring index is split."""

import collections

import numpy as np

from scanbench import harness, scenes
from scanbench.reference import levels

# int(MAX_SLAB_COLS * 0.94) of both packages' gated nearest-neighbour
# index: past it the index is a set of parts
SPLIT_LIMIT = 369623


def test_studio_cell_resolves():
    cell = harness.load_cell("studio.move4all")
    assert cell["workload"]["chips"] == 1
    assert cell["config"]["name"] == "studio-6x6-10obj"
    assert cell["config"]["reduced"] == []
    assert len(scenes.room_of(cell["config"]).objects) == 10
    assert {m["name"] for m in cell["end_to_end"]} == {"rescan_s", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "slab_split_s", "set_merge_s", "k1_set_roofline"}


def test_studio_pool_and_twins():
    cell = harness.load_cell("studio.move4all")
    room = scenes.room_of(cell["config"])
    twins = scenes.twin_groups(room)
    first = scenes.FIRST_OBJECT_ID
    groups = collections.Counter(twins[g] for g in twins if g >= first)
    assert sorted((n, room.objects[g - first].cls)
                  for g, n in groups.items() if n > 1) == [
        (2, "night_stand"), (4, "chair")]
    for seed in (1, 2 ** 31 + 7, 2 ** 33 + 11):
        pool = scenes.draw_pool(room, cell["traffic"], seed)
        assert len(pool) == cell["traffic"]["pool"] == 3
        for r in pool:
            moved = [k for k, (a, b) in enumerate(zip(room.objects,
                                                      r.objects)) if a != b]
            assert len(moved) == 4


def test_studio_scan_splits_the_scoring_index():
    cell = harness.load_cell("studio.move4all")
    mesh = scenes.scene_mesh(scenes.room_of(cell["config"]),
                             cell["config"]["mesh_resolution"])
    l0 = levels.resample(mesh)
    l1 = levels.poisson(l0["positions"], levels.VOXELS[1])
    assert len(l0["positions"]) > 1_700_000
    assert len(l1) > SPLIT_LIMIT
    assert np.isfinite(l0["positions"]).all()
