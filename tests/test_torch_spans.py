"""The port's stage trace (rescan_tpu_torch/utils/timing.py): the stage
root's seconds and self seconds, spans that add up over their call
sites, the host waits and their count, the profiler ranges, and the
benchmark's readers of the new spans (scanbench/metrics)."""

import contextvars
import io
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout

import pytest
import torch

from rescan_tpu_torch import sequences
from rescan_tpu_torch.pipeline import pose_proposal, seg2rsdb, segment_transfer
from rescan_tpu_torch.utils import synthetic, timing
from scanbench import harness

STAGES = ("pose_proposal", "segment_transfer")
NEW_KEYS = {
    "pose_proposal": ("io_load", "io_save", "levels", "host_wait",
                      "host_syncs", "stage", "stage_self"),
    "segment_transfer": ("io_load", "io_save", "levels", "host_wait",
                         "host_syncs", "stage", "stage_self"),
}
# the keys the benchmark's readers took before the stage trace, with the
# extents they had
OLD_KEYS = {
    "pose_proposal": ("total", "grid_search", "nms", "icp_refine",
                      "ingest", "grid_occupancy", "gs_prune_dispatch",
                      "gs_l4_collect", "refine_rescore",
                      "final_nms_sort_save"),
    "segment_transfer": ("total", "io_load", "label_smooth",
                         "refine_to_scene", "aug_icp", "aug_extract",
                         "aug_merge", "augment", "label_transfer"),
}
# the spans directly under each stage's root: ``total`` is not one, the
# substages inside it are
SUBSTAGES = {
    "pose_proposal": ("io_load", "ingest", "grid_occupancy", "grid_search",
                      "nms", "icp_refine", "refine_rescore",
                      "final_nms_sort_save"),
    "segment_transfer": ("io_load", "scene_analysis", "greedy",
                         "simulated_annealing", "add_static",
                         "refine_to_scene", "label_transfer", "augment",
                         "io_save"),
}
RESOLUTION = time.get_clock_info("perf_counter").resolution


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _ranges_off():
    yield
    timing.profiler_ranges(False)


def _rescan(root: str, class_file: str, scans) -> object:
    """seg2rsdb on the first scan, then pose_proposal (the prior reloaded
    from its .rsdb, as the stage CLIs do) and segment_transfer on the
    second, on the CPU; returns the database."""
    prior = os.path.join(root, "prior.rsdb")
    with redirect_stdout(io.StringIO()):
        seg2rsdb.run(scans[0], class_file, prior)
        db = pose_proposal.run(prior, scans[1],
                               os.path.join(root, "scan_pp.rsdb"),
                               device="cpu")
        return segment_transfer.run(os.path.join(root, "scan_pp.rsdb"),
                                    os.path.join(root, "scan.rsdb"), db=db,
                                    device="cpu")


@pytest.fixture(scope="module")
def rescan(tmp_path_factory):
    """The stages' timings of one rescan of the small sequence."""
    root = str(tmp_path_factory.mktemp("spans"))
    class_file = sequences.write_small_sequence(root)
    gt = os.path.join(root, sequences.SEQ_NAME, "gt_segmentation")
    db = _rescan(root, class_file, [os.path.join(gt, f"scan_00{i}.ply")
                                    for i in (0, 1)])
    return {"pose_proposal": db.last_pose_proposal_timings,
            "segment_transfer": db.last_segment_transfer_timings}


@pytest.fixture(scope="module")
def ranges(tmp_path_factory):
    """(name, start, end, thread) of every ``rescan.`` event of one rescan
    of a one-chair room (the small sequence takes minutes under the
    profiler on the CPU), traced with the program's ranges off (False)
    and on (True)."""
    root = str(tmp_path_factory.mktemp("ranges"))
    spec = synthetic.SceneSpec(room_size=(1.0, 1.0), wall_height=0.6,
                               objects=[("chair", (0.5, 0.5),
                                         (0.3, 0.4, 0.3), 0.0)])
    scans = [os.path.join(root, f"scan_00{i}.ply") for i in (0, 1)]
    for i, room in enumerate([spec, synthetic.moved_scene_spec(
            spec, (0.1, 0.05), which=0)]):
        synthetic.save_scene_ply(scans[i], room, resolution=4, seed=i)
    class_file = os.path.join(root, "classes.txt")
    synthetic.write_class_file(class_file)
    out = {}
    for on in (False, True):
        timing.profiler_ranges(on)
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                _rescan(root, class_file, scans)
        finally:
            timing.profiler_ranges(False)
        out[on] = _kineto_ranges(prof)
    return out


def _kineto_ranges(prof):
    # the profiler's own events, without building its tree of them
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("rescan.")]


# ---------------------------------------------------------------------------
# one rescan of the small sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_rescan_gives_every_new_key(rescan, stage):
    t = rescan[stage]
    for key in NEW_KEYS[stage] + OLD_KEYS[stage]:
        assert key in t, key
        assert math.isfinite(t[key]) and t[key] >= 0, (key, t[key])


@pytest.mark.parametrize("stage", STAGES)
def test_rescan_stage_self_and_direct_children(rescan, stage):
    t = rescan[stage]
    assert 0 <= t["stage_self"] <= t["stage"]
    # io_load, io_save and the rest of the root are disjoint
    assert t["io_load"] + t["io_save"] + t["stage_self"] \
        <= t["stage"] + 1e-6
    assert t["levels"] <= t["stage"]
    assert t["total"] <= t["stage"]


@pytest.mark.parametrize("stage", STAGES)
def test_rescan_stage_self_is_the_stage_less_its_substages(rescan, stage):
    t = rescan[stage]
    # the time inside ``total`` that no substage covers is self time
    assert t["stage_self"] + sum(t[k] for k in SUBSTAGES[stage]) \
        == pytest.approx(t["stage"], abs=1e-6)


@pytest.mark.parametrize("stage", STAGES)
def test_no_host_sync_on_the_cpu(rescan, stage):
    assert rescan[stage]["host_syncs"] == 0


def test_ranges_nest_inside_their_stage(ranges):
    events = ranges[True]
    for stage, key in (("pose_proposal", "io_load"),
                       ("segment_transfer", "levels")):
        (root,) = [e for e in events if e[0] == "rescan." + stage]
        inner = [e for e in events if e[0] == f"rescan.{stage}.{key}"]
        assert inner, key
        for e in inner:
            assert root[1] <= e[1] <= e[2] <= root[2], (key, e, root)
            assert e[3] == root[3]


# ---------------------------------------------------------------------------
# the trace on synthetic blocks
# ---------------------------------------------------------------------------

def test_stage_self_is_the_root_less_its_children():
    t = {}
    with timing.stage("demo", t):
        time.sleep(0.02)
        with timing.span("a"):
            time.sleep(0.1)
        with timing.span("b"):
            time.sleep(0.02)
            with timing.span("c"):
                time.sleep(0.02)
                with timing.span("d"):
                    time.sleep(0.02)
        time.sleep(0.01)
    assert t["stage_self"] == pytest.approx(
        t["stage"] - t["a"] - t["b"], abs=RESOLUTION)
    # the root's own 0.03 s; with a child's 0.06 s or more it is wrong
    assert 0.03 <= t["stage_self"] < 0.15
    assert t["d"] < t["c"] < t["b"]
    assert t["a"] + t["b"] + t["stage_self"] == pytest.approx(
        t["stage"], abs=RESOLUTION)


def test_a_span_that_does_not_nest_leaves_its_children_to_the_root():
    t = {}
    with timing.stage("demo", t):
        with timing.span("total", nest=False):
            with timing.span("a"):
                time.sleep(0.05)
            time.sleep(0.03)
            with timing.span("b"):
                with timing.span("c"):
                    time.sleep(0.02)
    assert t["total"] >= 0.1
    assert t["c"] <= t["b"]
    # the 0.03 s inside ``total`` under no span are the root's own
    assert t["stage_self"] == pytest.approx(t["stage"] - t["a"] - t["b"],
                                            abs=RESOLUTION)
    assert 0.03 <= t["stage_self"] < 0.05


def test_a_key_adds_up_and_counts_once_when_nested():
    t = {}
    with timing.stage("demo", t):
        for _ in range(2):
            with timing.span("levels"):
                time.sleep(0.01)
                with timing.span("levels"):      # already open: no more
                    time.sleep(0.01)
    assert 0.04 <= t["levels"] <= t["stage"]
    assert t["stage_self"] == pytest.approx(t["stage"] - t["levels"],
                                            abs=RESOLUTION)


def test_span_seconds_and_nothing_recorded_outside_a_stage():
    with timing.span("x") as s:
        time.sleep(0.005)
    assert s.seconds >= 0.005
    t = {}
    with timing.stage("demo", t):
        pass
    with timing.span("x"):
        pass
    assert set(t) == {"stage", "stage_self"}


def test_worker_spans_go_to_the_stage_but_not_its_self_time():
    t = {}
    with timing.stage("demo", t), ThreadPoolExecutor(max_workers=1) as ex:

        def work():
            with timing.span("worker"):
                time.sleep(0.02)
            with timing.host_wait("cuda", n=2):
                time.sleep(0.01)
            return threading.get_ident()

        f = ex.submit(contextvars.copy_context().run, work)
        assert f.result() != threading.get_ident()
    assert t["worker"] >= 0.02
    # the worker's waits are counted; their seconds are not the stage's
    assert t["host_syncs"] == 2 and "host_wait" not in t
    assert t["stage_self"] == pytest.approx(t["stage"], abs=RESOLUTION)


def test_host_waits_on_the_cpu_count_nothing():
    t = {}
    with timing.stage("demo", t):
        a = timing.to_host(torch.arange(3))
        b = timing.to_device(torch.ones(2), "cpu")
        with timing.host_wait(torch.device("cpu"), n=3):
            pass
    assert a.tolist() == [0, 1, 2] and b.tolist() == [1.0, 1.0]
    assert t["host_syncs"] == 0 and t["host_wait"] >= 0
    t = {}
    with timing.stage("demo", t), timing.host_wait("cuda:0", n=3):
        pass
    assert t["host_syncs"] == 3


def test_stage_timer_prints_its_line():
    t = {}
    buf = io.StringIO()
    with redirect_stdout(buf), timing.stage("demo", t):
        with timing.stage_timer("save", "Saving database took %fs."):
            pass
        with timing.stage_timer("quiet", "never %fs", verbose=False):
            pass
    assert buf.getvalue().startswith("Saving database took ")
    assert buf.getvalue().count("\n") == 1
    assert {"save", "quiet"} <= set(t)


def _traced(ranges: bool):
    timing.profiler_ranges(ranges)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.stage("pose_proposal", {}):
            with timing.span("io_load"):
                timing.to_host(torch.ones(4) * 2)
        with timing.span("outside"):
            pass
    timing.profiler_ranges(False)
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_no_range_while_ranges_are_off(ranges):
    assert ranges[False] == []
    names = _traced(False)
    assert names and not [n for n in names if n.startswith("rescan.")]


def test_ranges_name_stage_and_span():
    names = _traced(True)
    for want in ("rescan.pose_proposal", "rescan.pose_proposal.io_load",
                 "rescan.pose_proposal.host_wait", "rescan.outside"):
        assert want in names, want


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------

def _record():
    def stage(**kw):
        base = dict(io_load=0.0, io_save=0.0, levels=0.0, host_wait=0.0,
                    stage=0.0, stage_self=0.0)
        return dict(base, **kw)
    return {"rescans": [
        {"seconds": 10.0,
         "pose_proposal": stage(io_load=1.0, io_save=0.25, levels=2.0,
                                host_wait=0.5, stage=4.0, stage_self=0.1),
         "segment_transfer": stage(io_save=0.5, levels=1.0, host_wait=0.25,
                                   stage=5.5, stage_self=0.2)},
        {"seconds": 12.0,
         "pose_proposal": stage(io_load=3.0, io_save=0.75, levels=4.0,
                                host_wait=1.5, stage=5.0, stage_self=0.3),
         "segment_transfer": stage(io_save=1.5, levels=3.0, host_wait=0.75,
                                   stage=6.0, stage_self=0.4)}]}


@pytest.mark.parametrize("name,want", [
    ("prior_load_s", 2.0),
    ("save_s", 1.5),
    ("levels_s", 5.0),
    ("host_wait_s", 1.5),
    # (10 - 9.5 + 0.3 + 12 - 11 + 0.7) / 2
    ("untraced_s", 1.25),
])
def test_span_metric_reads_the_mean(name, want):
    read = harness.reader(name)
    assert read(_record()) == pytest.approx(want)
    # the parent's record: the stages' timings without the spans
    old = {"rescans": [{"seconds": 10.0, "pose_proposal": {"total": 4.0},
                        "segment_transfer": {"total": 5.0}}]}
    assert read(old) is None
    assert read({"rescans": []}) is None
