"""The port (trackformer_tpu_torch) and chip_smoke.py must run where JAX
and flax are absent, as on the machine with the card: every module of the
package imports, and tiny tracker runs of both encoder modes (exact MSDA,
and the TPU-fast windowed mode with the cached memory, through `Tracker`
and `BatchedTracker`) and one two-frame training step of the exact mode go
through on the CPU, in a subprocess in which
importing jax, jaxlib or flax raises. The port keeps its own copies of
what it needs from the JAX side of the repository: the same run records
every file opened under `trackformer_tpu/` or `tools/`, and there must be
none."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

BLOCKED_RUN = r'''
import importlib, importlib.abc, importlib.util, os, pkgutil, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, NoJax())
JAX_SIDE = [os.path.realpath(d) + os.sep for d in ("trackformer_tpu", "tools")]
opened_outside = []

def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        path = os.path.realpath(os.fsdecode(args[0]))
        if any(path.startswith(d) for d in JAX_SIDE):
            opened_outside.append(path)

sys.addaudithook(audit)
import torch
import trackformer_tpu_torch
for mod in pkgutil.walk_packages(trackformer_tpu_torch.__path__,
                                 "trackformer_tpu_torch."):
    importlib.import_module(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))

from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import BatchedTracker, Tracker
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)
tiny = dict(dec_layers=1, hidden_dim=96, nheads=4, dim_feedforward=64,
            num_queries=8, compute_dtype="float32", max_tracks=4)
img = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(1))
blob = {"batch": FrameBatch.from_images(img),
        "orig_size": torch.tensor([[64, 96]])}
for cfg in (FlagshipConfig().replace(enc_layers=1, **tiny),
            FlagshipConfig.tpu_fast(enc_layers=2, **tiny)):
    model, post = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    tracker_cfg = {**cfg.tracker_cfg, "max_tracks": 4}
    tracker = Tracker(model, post, tracker_cfg, cfg.hidden_dim,
                      cfg.num_queries)
    for _ in range(2):
        tracker.step(blob)
    assert tracker.frame_index == 2
    if cfg.cached_prev_memory:
        batched = BatchedTracker(model, post, tracker_cfg, cfg.hidden_dim,
                                 cfg.num_queries)
        assert len(batched.run([[blob, blob], [blob, blob]])) == 2

from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.structures import empty_targets

cfg = FlagshipConfig().replace(enc_layers=1, **tiny)
gen = torch.Generator().manual_seed(0)
model, crit, _, track = build_model(cfg, "cpu", gen, train=True)
optimizer = make_optimizer(cfg, model)
state = TrainState.create(model, optimizer)
targets = empty_targets(1, 3, "cpu")
targets.valid[:, :2] = True
targets.boxes[:, :2] = torch.tensor([[.3, .3, .2, .2], [.6, .6, .2, .3]])
targets.track_ids[:, :2] = torch.arange(2, dtype=torch.int32)
pack = {"batch": blob["batch"], "targets": targets,
        "prev_batch": blob["batch"], "prev_targets": targets}
step = make_train_step(model, crit, optimizer, track, tracking=True)
state, metrics = step(state, pack, gen)
assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
assert not any(k.split(".")[0] in ("jax", "jaxlib", "flax")
               for k in sys.modules)
print("NO_JAX_OK")
print("OPENED_OUTSIDE=" + repr(opened_outside))
'''


@pytest.fixture(scope="module")
def blocked_run():
    return subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_and_runs_without_jax(blocked_run):
    assert blocked_run.returncode == 0, blocked_run.stderr[-3000:]
    assert "NO_JAX_OK" in blocked_run.stdout


def test_port_reads_no_file_of_the_jax_side(blocked_run):
    assert blocked_run.returncode == 0, blocked_run.stderr[-3000:]
    assert "OPENED_OUTSIDE=[]" in blocked_run.stdout, blocked_run.stdout


def test_no_jax_import_lines_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b", re.M)
    files = sorted((REPO / "trackformer_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
