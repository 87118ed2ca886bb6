"""The port's three evaluators (rescan_tpu_torch/eval/) against the JAX
package's, on the same ScanNet-format eval files, CPU on both sides; and
the port's small 3-scan sequence, driver and evaluators, against the
JAX package's committed outputs and metrics
(tests/data/torch_port_small3_ref.npz, its CPU search engine, and
tests/data/torch_port_small3_slab_ref.npz, the sorted slab).

The eval-file fixture is tests/test_eval_xcheck.py's (two 1200-vertex
scans, label noise, a merged instance) with the cases the device code
must get right: negative ids and ids >= 256, a mask under
MIN_REGION_SIZE, a class absent from GT, an id-equivalence file, and a
prediction file naming an absolute and an escaping mask path. Metric
dicts are equal with ``==`` (NaN in the same places), CLI output files
byte for byte, errors with the same type and message.
"""

import contextlib
import importlib
import io
import math
import os

import numpy as np
import pytest
import torch

from rescan_tpu.eval import instance_transfer as j_it
from rescan_tpu.eval import semantic_instance as j_si
from rescan_tpu.eval import semantic_label as j_sl
import rescan_tpu_torch
from rescan_tpu_torch import sequences
from rescan_tpu_torch.eval import instance_transfer as t_it
from rescan_tpu_torch.eval import semantic_instance as t_si
from rescan_tpu_torch.eval import semantic_label as t_sl
from rescan_tpu_torch.pipeline import driver as tdriver

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_small3_ref.npz")
REF_SLAB = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_small3_slab_ref.npz")
TASKS = ("semantic_label", "instance_transfer", "semantic_instance")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_ids(path, ids):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, np.asarray(ids, np.int64), fmt="%d")


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """Two 1200-vertex scans: classes wall(1)/chair(5)/table(7), globally
    unique instance ids, ~8% prediction label noise + one merged
    instance, and the edge cases of the module docstring."""
    root = tmp_path_factory.mktemp("eval_root")
    ev = root / "eval"
    rng = np.random.default_rng(7)
    for s, scan in enumerate(["scan_000", "scan_001"]):
        n = 1200
        gt = np.zeros(n, np.int64)
        # encoded 1000*class + instance (create_eval_files encoding)
        gt[:400] = 1000 * 1 + 0          # wall, static (instance 0)
        gt[400:700] = 1000 * 5 + 1       # chair_1
        gt[700:900] = 1000 * 5 + 2       # chair_2
        gt[900:1200] = 1000 * 7 + 3      # table_3
        gt[390:400] = 5256               # instance 256: outside the matrix
        gt[380:390] = -1005              # a negative (void) id
        pred = gt.copy()
        flip = rng.random(n) < 0.08
        pred[flip & (gt == 5001)] = 5002        # chair_1 -> chair_2 bleed
        pred[flip & (gt == 7003)] = 1000        # table -> wall bleed
        pred[:6] = -7                            # negative prediction ids
        pred[6:12] = 5300                        # instance >= 256
        pred[12:20] = 42000                      # class > 40
        if s == 1:
            pred[700:760] = 5001                 # partial instance merge
            pred[400:700] = 5002                 # chair_1 labelled chair_2
            pred[700:900] = 5001
        for task in TASKS:
            vals_gt = gt // 1000 if task == "semantic_label" else gt
            if task == "instance_transfer":
                # a negative GT id has instance -1005 % 1000 = 995, outside
                # the matrix: both packages raise (tested below)
                vals_gt = np.where(gt < 0, 0, gt)
            vals_pr = pred // 1000 if task == "semantic_label" else pred
            _write_ids(str(ev / task / "gt_segmentation" / f"{scan}.txt"),
                       vals_gt)
            if task != "semantic_instance":
                _write_ids(str(ev / task / "predictions" / f"{scan}.txt"),
                           vals_pr)
        # semantic_instance predictions: index file + binary masks
        si = ev / "semantic_instance" / "predictions"
        masks = si / "predicted_masks"
        os.makedirs(masks, exist_ok=True)
        lines = []
        for iid, conf in ((5001, 0.9), (5002, 0.7), (7003, 0.85)):
            mask = (pred == iid).astype(np.int64)
            name = f"{scan}_{iid % 1000:03d}.txt"
            _write_ids(str(masks / name), mask)
            lines.append(f"predicted_masks/{name} {iid // 1000} {conf:f}\n")
        small = np.zeros(n, np.int64)
        small[900:950] = 1                       # under MIN_REGION_SIZE
        _write_ids(str(masks / f"{scan}_small.txt"), small)
        lines.append(f"predicted_masks/{scan}_small.txt 7.0 0.95\n")
        absent = np.zeros(n, np.int64)
        absent[0:150] = 1                        # bookshelf: not in GT
        _write_ids(str(masks / f"{scan}_absent.txt"), absent)
        lines.append(f"predicted_masks/{scan}_absent.txt 10 0.6\n")
        lines.append(f"predicted_masks/{scan}_absent.txt 77 0.5\n")
        lines.append("a line that is not a prediction\n")
        with open(si / f"{scan}.txt", "w") as f:
            f.writelines(lines)
    # the reference protocol's id-equivalence file for the two chairs
    # (0-based ids), where instance_transfer's CLI looks for it from cwd
    eq = root / "scan" / "gt_segmentation"
    os.makedirs(eq)
    for scan in ("scan_000", "scan_001"):
        (eq / f"{scan}.txt").write_text("0 | 0 1\n1 | 0 1\n")
    return str(root)


def _files(root, task):
    d = os.path.join(root, "eval", task, "predictions")
    preds = [os.path.join(d, f) for f in sorted(os.listdir(d))
             if f.endswith(".txt")]
    return preds, [p.replace("predictions", "gt_segmentation") for p in preds]


def _same(a, b):
    """Equal with ==, NaN where the other is NaN, through dicts, lists
    and tuples."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


def test_semantic_label_matches_jax(eval_root):
    preds, gts = _files(eval_root, "semantic_label")
    want = j_sl.evaluate(preds, gts)
    got = t_sl.evaluate(preds, gts, device="cpu")
    assert _same(want, got), (want, got)
    assert 0.0 < want["chair"][0] < 1.0
    assert want["bookshelf"][2] == 0 and math.isnan(want["bookshelf"][0])


def test_instance_transfer_matches_jax(eval_root):
    preds, gts = _files(eval_root, "instance_transfer")
    eq = os.path.join(eval_root, "scan", "gt_segmentation")
    for p, g in zip(preds, gts):
        pred = np.loadtxt(p, dtype=np.int64)
        gt = np.loadtxt(g, dtype=np.int64)
        want = j_it.scan_confusion(pred, gt)
        got = t_it.scan_confusion(pred, gt, device="cpu")
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert want[:, 256].sum() > 0            # ids >= 256 and < 0
        for eq_file in (None, os.path.join(eq, os.path.basename(p))):
            a = j_it.evaluate_scan(p, g, eq_file)
            b = t_it.evaluate_scan(p, g, eq_file, device="cpu")
            assert _same(a, b), (p, eq_file, a, b)
    # the equivalence file undoes scan_001's chair swap
    p1, g1 = preds[1], gts[1]
    assert (j_it.evaluate_scan(p1, g1, os.path.join(eq, "scan_001.txt"))
            > j_it.evaluate_scan(p1, g1) + 0.1)


def test_instance_transfer_ids_outside_the_matrix(tmp_path):
    """GT ids whose instance (Python modulo: -5 % 1000 == 995) lies
    outside the 257 x 257 matrix: equal matrices, and the same IndexError
    from both evaluators."""
    gt = np.array([5001, 5001, -5, 5001], np.int64)
    pred = np.array([5001, -3, 5001, 7300], np.int64)
    want = j_it.scan_confusion(pred, gt)
    got = t_it.scan_confusion(pred, gt, device="cpu")
    assert np.array_equal(got, want) and got[1, 256] == 2
    _write_ids(str(tmp_path / "p.txt"), pred)
    _write_ids(str(tmp_path / "g.txt"), gt)
    errs = []
    for fn, kw in ((j_it.evaluate_scan, {}),
                   (t_it.evaluate_scan, {"device": "cpu"})):
        with pytest.raises(IndexError) as e:
            fn(str(tmp_path / "p.txt"), str(tmp_path / "g.txt"), **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_semantic_instance_matches_jax(eval_root):
    preds, gts = _files(eval_root, "semantic_instance")
    for p, g in zip(preds, gts):
        want = j_si.assign_instances_for_scan(p, g)
        got = t_si.assign_instances_for_scan(p, g, device="cpu")
        assert _same(list(want), list(got))
    want = j_si.evaluate(preds, gts)
    got = t_si.evaluate(preds, gts, device="cpu")
    assert _same(want, got), (want, got)
    assert 0.0 < want["all_ap"] < 1.0
    assert math.isnan(want["classes"]["bookshelf"]["ap"])


_MAINS = {"semantic_label": (j_sl, t_sl),
          "instance_transfer": (j_it, t_it),
          "semantic_instance": (j_si, t_si)}


@pytest.mark.parametrize("task", TASKS)
def test_cli_outputs_byte_identical(eval_root, task, tmp_path, monkeypatch):
    """Each CLI with the reference argv (the port's with --device cpu):
    the same output file, byte for byte, and the same stdout. cwd is the
    fixture root, where instance_transfer finds the equivalence files."""
    monkeypatch.chdir(eval_root)
    d = os.path.join(eval_root, "eval", task)
    outs = []
    for mod, extra in zip(_MAINS[task], ([], ["--device", "cpu"])):
        out = str(tmp_path / f"{mod.__name__}.txt")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(["--pred_path", os.path.join(d, "predictions"),
                             "--gt_path", os.path.join(d, "gt_segmentation"),
                             "--output_file", out] + extra) == 0
        with open(out, "rb") as f:
            outs.append((f.read(), buf.getvalue()))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) > 50


def _errors_of_both(pred_file, gt_file, exc):
    errs = []
    for fn, kw in ((j_si.assign_instances_for_scan, {}),
                   (t_si.assign_instances_for_scan, {"device": "cpu"})):
        with pytest.raises(exc) as e:
            fn(pred_file, gt_file, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    return errs[0]


@pytest.mark.parametrize("line,match", [
    ("/etc/passwd 5 0.9\n", "must be relative"),
    ("../gt/scan_000.txt 5 0.9\n", "outside of the prediction path"),
])
def test_mask_path_validation(eval_root, tmp_path, line, match):
    """A prediction file may not point the evaluator outside its own
    directory: the same ValueError from both packages."""
    os.makedirs(tmp_path / "predictions")
    pf = str(tmp_path / "predictions" / "bad.txt")
    with open(pf, "w") as f:
        f.write(line)
    g = os.path.join(eval_root, "eval", "semantic_instance",
                     "gt_segmentation", "scan_000.txt")
    assert match in _errors_of_both(pf, g, ValueError)


def test_mask_length_mismatch(eval_root, tmp_path):
    _write_ids(str(tmp_path / "predicted_masks" / "s.txt"),
               np.ones(10, np.int64))
    pf = str(tmp_path / "short.txt")
    with open(pf, "w") as f:
        f.write("predicted_masks/s.txt 5 0.9\n")
    g = os.path.join(eval_root, "eval", "semantic_instance",
                     "gt_segmentation", "scan_000.txt")
    assert "has 10 lines" in _errors_of_both(pf, g, ValueError)


@pytest.mark.parametrize("task", TASKS)
def test_entry_points_without_card_raise(eval_root, task):
    """No device named means CUDA: without a card each evaluator and CLI
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = _MAINS[task][1]
    preds, gts = _files(eval_root, task)
    fn = {"semantic_label": lambda: mod.evaluate(preds, gts),
          "instance_transfer": lambda: mod.evaluate_scan(preds[0], gts[0]),
          "semantic_instance": lambda: mod.evaluate(preds, gts)}[task]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()
    d = os.path.join(eval_root, "eval", task)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--pred_path", os.path.join(d, "predictions"),
                  "--gt_path", os.path.join(d, "gt_segmentation")])


def _run_small3(root, run, **kw):
    class_file = sequences.write_eval_sequence(root, small=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run(sequences.SEQ_NAME, class_file,
            eval_folder=os.path.join(root, sequences.EVAL_DIR), **kw)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def port_small3(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_small3"))
    _run_small3(root, tdriver.run_sequence, device="cpu")
    return root


def test_port_small3_matches_committed_reference(port_small3):
    """The port's driver and evaluators over the small 3-scan sequence on
    the CPU, held to ``sequences.compare_outputs`` (one set of
    tolerances for every rescan) against the JAX package's committed run
    on the sorted slab, its accelerator path: both rescans, every
    proposal within 1e-6 in pose and score (measured bit-identical, the
    arrangements and labels too). Against its committed run on the CPU's
    HashGrid: rescan 1 within the same tolerances, and the five metrics
    within ``sequences.compare_metrics``; rescan 2 with its lower-ranked
    proposals at the other-engine limits: the JAX package's own two
    engines part there by 1.6e-3 on one lower-ranked proposal (the
    HashGrid rounds its distances otherwise, and that ICP stops at
    another iteration; sequences.py)."""
    ref = dict(np.load(REF))
    slab = dict(np.load(REF_SLAB))
    got = sequences.sequence_outputs(port_small3)
    assert sequences.rescans(port_small3) == ["scan_001", "scan_002"]
    assert sorted(got) == sorted(k for k in ref if "/" in k
                                 and not k.startswith("metric/"))
    for sub in ("scan_001", "scan_002"):
        r = sequences.split_outputs(slab, sub)
        g = sequences.split_outputs(got, sub)
        assert sequences.compare_outputs(r, g) == [], sub
        np.testing.assert_allclose(g["prop_poses"], r["prop_poses"], rtol=0,
                                   atol=1e-6, err_msg=sub)
        np.testing.assert_allclose(g["prop_scores"], r["prop_scores"],
                                   rtol=0, atol=1e-6, err_msg=sub)
    assert sequences.compare_outputs(
        sequences.split_outputs(ref, "scan_001"),
        sequences.split_outputs(got, "scan_001")) == []
    assert sequences.compare_outputs(
        sequences.split_outputs(ref, "scan_002"),
        sequences.split_outputs(got, "scan_002"), other_engine=True) == []
    metrics = sequences.evaluate_sequence(port_small3, device="cpu")
    want = {k: float(ref[f"metric/{k}"]) for k in sequences.METRICS}
    assert sequences.compare_metrics(want, metrics) == []
    assert 0.5 < metrics["semantic_label_mIoU"] < 1.0


def test_other_engine_limits_rest_on_the_jax_engines():
    """sequences.OTHER_ENGINE_* against their witness: the JAX package's
    own runs of the small 3-scan sequence and of the bench rescan on the
    sorted slab and on the CPU's HashGrid (the committed files) part on
    lower-ranked proposals by more than the one-engine limits, and stay
    within the other-engine ones; counts, top-1 proposals, arrangements
    and labels agree at the one-engine limits."""
    data = os.path.join(os.path.dirname(__file__), "data")
    runs = [(sequences.split_outputs(dict(np.load(REF_SLAB)), sub),
             sequences.split_outputs(dict(np.load(REF)), sub))
            for sub in ("scan_001", "scan_002")]
    runs.append(tuple(dict(np.load(os.path.join(data, f))) for f in (
        "torch_port_bench_slab_ref.npz", "torch_port_bench_ref.npz")))
    beyond = []
    for slab, grid in runs:
        assert sequences.compare_outputs(slab, grid, other_engine=True) == []
        bad = sequences.compare_outputs(slab, grid)
        assert all(b.startswith("proposals:") for b in bad), bad
        beyond.append(bool(bad))
    # rescan 2 of the small sequence and the bench rescan need the limits
    assert beyond == [False, True, True]


def test_port_evaluators_match_jax_on_the_sequence(port_small3):
    """The port's evaluators and the JAX package's on the eval files of
    the port's run: the same metrics, exactly."""
    got = sequences.evaluate_sequence(port_small3, device="cpu")
    want = sequences.evaluate_sequence(port_small3,
                                       evaluators=(j_sl, j_it, j_si))
    assert _same(want, got), (want, got)
    assert len(got["instance_transfer_mIoU_per_scan"]) == 2


def test_eval_sequence_twins_get_equivalence_files(tmp_path):
    """The bench room's two chairs are twins: write_eval_sequence writes
    the reference protocol's equivalence lines for each rescan (GT ids
    3 and 4); the small room has none. Only the ply writing is run at
    the bench room's size 2, so this stays quick."""
    from rescan_tpu_torch.utils import synthetic
    assert sequences._twin_groups(sequences._BENCH_ROOM) == [[3, 4]]
    assert sequences._twin_groups(sequences._SMALL_ROOM) == []
    root = str(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        real = synthetic.save_scene_ply
        mp.setattr(synthetic, "save_scene_ply",
                   lambda path, spec, resolution, seed: real(
                       path, spec, resolution=4, seed=seed))
        sequences.write_eval_sequence(root, small=False, n_scans=3)
    eq = os.path.join(root, "eval", "instance_transfer", "id_equivalences")
    assert sorted(os.listdir(eq)) == ["scan_001.txt", "scan_002.txt"]
    with open(os.path.join(eq, "scan_002.txt")) as f:
        assert f.read() == "3 | 3 4\n4 | 3 4\n"
    assert sequences.rescans(root) == ["scan_001", "scan_002"]


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["hashgrid", "slab"])
def test_jax_reproduces_committed_small3_reference(tmp_path, engine):
    """The references chip_smoke.py's phase 7 holds the card to are still
    what the JAX package computes; regenerate them with
    ``tools/make_torch_port_ref.py --eval [--slab]`` when the JAX package
    changes. Slow: the JAX driver over three scans takes minutes on one
    worker (the slab's Pallas kernel in interpret mode, ten)."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_ref", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "make_torch_port_ref.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RESCAN_DEVICES", "1")
        if engine == "slab":
            tool.search_on_the_slab(mp)
        got = tool.jax_small3_outputs(str(tmp_path))
    ref = np.load(REF_SLAB if engine == "slab" else REF)
    assert sorted(ref.files) == sorted(got)
    for k in ref.files:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_cpu_calls_counts_device_work_on_cpu_tensors():
    """CPU_CALLS counts device work that ran on CPU tensors (chip_smoke
    holds it at 0 on the card); naming the CPU is counted."""
    rescan_tpu_torch.CPU_CALLS.clear()
    conf = torch.zeros((42, 42), dtype=torch.int64)
    t_sl.accumulate_confusion(np.array([5, 5, 0]), np.array([5, 3, 5]), conf)
    assert rescan_tpu_torch.CPU_CALLS == {
        "semantic_label.accumulate_confusion": 1}
    assert int(conf[5, 5]) == 1 and int(conf[3, 5]) == 1 and \
        int(conf[5, 41]) == 1
    rescan_tpu_torch.CPU_CALLS.clear()
