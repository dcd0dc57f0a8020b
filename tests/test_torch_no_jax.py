"""The port (trackformer_tpu_torch) and chip_smoke.py must run where JAX
and flax are absent, as on the machine with the card: every module of the
package imports, and a tiny tracker step runs on the CPU, in a subprocess
in which importing jax, jaxlib or flax raises."""
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

BLOCKED_RUN = r'''
import importlib, importlib.abc, importlib.util, pkgutil, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, NoJax())
import torch
import trackformer_tpu_torch
for mod in pkgutil.walk_packages(trackformer_tpu_torch.__path__,
                                 "trackformer_tpu_torch."):
    importlib.import_module(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))

from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import Tracker
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)
cfg = FlagshipConfig().replace(enc_layers=1, dec_layers=1, hidden_dim=96,
                               nheads=4, dim_feedforward=64, num_queries=8,
                               compute_dtype="float32", max_tracks=4)
model, post = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
tracker = Tracker(model, post, {**cfg.tracker_cfg, "max_tracks": 4},
                  cfg.hidden_dim, cfg.num_queries)
img = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(1))
for _ in range(2):
    tracker.step({"batch": FrameBatch.from_images(img),
                  "orig_size": torch.tensor([[64, 96]])})
assert tracker.frame_index == 2
assert not any(k.split(".")[0] in ("jax", "jaxlib", "flax")
               for k in sys.modules)
print("NO_JAX_OK")
'''


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_no_jax_import_lines_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b", re.M)
    files = sorted((REPO / "trackformer_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
