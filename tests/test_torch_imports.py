"""Import hygiene of the PyTorch port, and its copy of the configs.

The port imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package ``repro`` (not even its stdlib-only config modules): a fresh
interpreter that imports every module of ``repro_torch``, ``chip_smoke``
and ``chip_ab`` must end with neither in ``sys.modules``.  The port keeps
its own copy of the configs instead, which must equal the JAX package's
field by field.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as jconfigs
from repro.common import config as jconfig
from repro_torch import configs as tconfigs
from repro_torch.common import config as tconfig

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
import chip_ab
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("MODULES", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = dict(line.split(" ", 1) for line in res.stdout.splitlines())
    assert int(lines["MODULES"]) >= 20
    assert lines["BAD"] == "[]", lines["BAD"]


def test_port_sources_name_no_jax_import():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import")), f"{f}: {s}"


@pytest.mark.parametrize("arch", ["llama3-8b", "tiny-llama", "hymba-1.5b",
                                  "mamba2-130m"])
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_equals_jax_config(arch, smoke):
    get_j = jconfigs.get_smoke_config if smoke else jconfigs.get_config
    get_t = tconfigs.get_smoke_config if smoke else tconfigs.get_config
    want, got = get_j(arch), get_t(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab == want.padded_vocab
    assert got.num_params() == want.num_params()


def test_config_dataclasses_have_the_same_fields():
    for name in ("AttentionConfig", "LookaheadConfig", "ModelConfig",
                 "EvictionConfig", "MoEConfig", "SSMConfig", "EncoderConfig",
                 "TrainConfig", "ShapeConfig"):
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(jconfig, name))]
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(tconfig, name))]
        assert got == want, name


def test_unported_arch_names_its_roadmap_item():
    with pytest.raises(KeyError, match="ROADMAP A10"):
        tconfigs.get_config("gemma3-1b")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")
