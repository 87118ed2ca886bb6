"""The port's whole rescan timestep against the JAX package's: seg2rsdb,
pose_proposal and segment_transfer through each package's driver, on the
2-scan sequence of tests/test_pipeline_e2e.py (chair moved by
(0.25, 0.15)), CPU on both sides.

Known differences between the two runs, both inside the tolerances of
rescan_tpu_torch.sequences.compare_outputs: the JAX package's CPU search
engine is the HashGrid (the port's is the slab, whose results are the
Pallas kernel's), and its smoothing graph comes from hashgrid.radius_knn
(the port's from the native HostGrid).
"""

import os

import numpy as np
import pytest
import torch

from rescan_tpu.pipeline import driver as jdriver
from rescan_tpu_torch import sequences
from rescan_tpu_torch.ops import gnn
from rescan_tpu_torch.pipeline import driver as tdriver

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_small_ref.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # one JAX device: conftest's 8 virtual devices would send the JAX
        # stages down the multi-device mesh path
        mp.setenv("RESCAN_DEVICES", "1")
        for name, run in (("jax", jdriver.run_sequence),
                          ("torch", tdriver.run_sequence)):
            root = str(tmp_path_factory.mktemp(name))
            class_file = sequences.write_small_sequence(root)
            mp.chdir(root)
            kw = {"device": "cpu"} if name == "torch" else {}
            gnn.reset_counts()
            produced = run(sequences.SEQ_NAME, class_file, **kw)
            out[name] = {"root": root, "class_file": class_file,
                         "produced": produced,
                         "outputs": sequences.read_outputs(root),
                         "plain_calls": dict(gnn.PLAIN_CALLS)}
    return out


def test_port_matches_jax_rescan(runs):
    j, t = runs["jax"]["outputs"], runs["torch"]["outputs"]
    assert runs["torch"]["produced"] == runs["jax"]["produced"]
    assert runs["torch"]["plain_calls"]["gated_min"] > 0
    assert runs["torch"]["plain_calls"]["nearest_gated"] > 0
    np.testing.assert_array_equal(t["prop_counts"], j["prop_counts"])
    assert (t["prop_counts"] > 0).all()
    assert sequences.compare_outputs(j, t) == []


def test_jax_reproduces_committed_reference(runs):
    """The reference the card is held to (chip_smoke.py) is still what
    the JAX package computes; regenerate it with
    tools/make_torch_port_ref.py when the JAX package changes."""
    ref = np.load(REF)
    got = runs["jax"]["outputs"]
    assert sorted(ref.files) == sorted(got)
    for k in ref.files:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_driver_cli_resume(runs, monkeypatch):
    """The port's CLI takes the reference driver's argv; with --resume on
    a finished sequence every timestep is skipped."""
    root = runs["torch"]["root"]
    monkeypatch.chdir(root)
    with open("scenes.txt", "w") as f:
        f.write(sequences.SEQ_NAME + "\n")
    before = os.path.getmtime(os.path.join(sequences.SEQ_NAME,
                                           "scan_001.rsdb"))
    assert tdriver.main(["scenes.txt", "--class_file",
                         runs["torch"]["class_file"], "--resume",
                         "--device", "cpu"]) == 0
    assert os.path.getmtime(os.path.join(sequences.SEQ_NAME,
                                         "scan_001.rsdb")) == before
