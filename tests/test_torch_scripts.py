"""The port's pipeline scripts (iris_tpu_torch/scripts/*.sh and
scenes/*.sh), the counterparts of scripts/{run_pipeline,render,
relight_demo,run_scale_demo}.sh and scripts/scenes/*.sh: run by
bash with their variables at their defaults (the required ones set) and a
stand-in `python` on the PATH that records each command, every
`python -m` line names a module of the port, and its flags parse with
that module's own parser (the parse is stopped before the CLI does any
work)."""

import argparse
import importlib
import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "iris_tpu_torch", "scripts")
SEP = "\x1f"

# the variables a script requires (${VAR:?}); the rest keep their defaults
REQUIRED = {"DATASET_PATH": "/data/kitchen", "EXP": "kitchen",
            "DATASET_ROOT": "/data/scannetpp"}
PIPELINE = ["slf_bake", "extract_emitter", "initialize", "extract_emitter",
            "bake_shading", "train_brdf_crf", "slf_refine", "train_emitter",
            "extract_emitter", "refine_shading", "train_brdf_crf"]
SCENES = sorted(n for n in os.listdir(os.path.join(SCRIPTS, "scenes"))
                if n.endswith(".sh"))


def _commands(script, tmp_path):
    """[(module, argv)] of every python call the script makes."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "calls.log"
    fake = bin_dir / "python"
    fake.write_text('#!/bin/sh\n'
                    f'(IFS="$(printf "\\037")"; echo "$*") >> "{log}"\n')
    fake.chmod(0o755)
    env = {"PATH": f"{bin_dir}:/usr/bin:/bin", "HOME": str(tmp_path),
           **REQUIRED}
    subprocess.run(["bash", os.path.join(SCRIPTS, script)], env=env,
                   cwd=str(tmp_path), check=True, timeout=60,
                   capture_output=True)
    calls = []
    for line in log.read_text().splitlines():
        args = line.split(SEP)
        assert args[0] == "-m", line
        calls.append((args[1], args[2:]))
    return calls


class _Parsed(Exception):
    pass


def _parse_only(module_name, argv, monkeypatch):
    """The namespace `module_name`'s main(argv) parses, its work never
    started."""
    module = importlib.import_module(module_name)
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed) as got:
        module.main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return got.value.args[0]


@pytest.mark.parametrize("script,modules", [
    ("run_pipeline.sh", [f"pipeline.{m}" for m in PIPELINE]),
    ("render.sh", ["pipeline.render"]),
    ("relight_demo.sh", ["pipeline.render_relight"]),
    ("run_scale_demo.sh", ["data.make_demo_dataset"]
     + [f"pipeline.{m}" for m in PIPELINE]
     + ["pipeline.render", "utils.metric_brdf", "utils.metric_crf"]),
] + [(f"scenes/{name}", [f"pipeline.{m}" for m in PIPELINE])
     for name in SCENES])
def test_script_lines_parse(script, modules, tmp_path, monkeypatch):
    calls = _commands(script, tmp_path)
    assert [m for m, _ in calls] == [f"iris_tpu_torch.{m}" for m in modules]
    for module, argv in calls:
        ns = _parse_only(module, argv, monkeypatch)
        assert getattr(ns, "device", None) is None, module   # the card


def _shell_lines(path):
    with open(path) as f:
        return [ln.strip() for ln in f.read().splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")]


def test_scripts_mirror_the_jax_scripts():
    """Each script (scripts/ and scripts/scenes/ of the JAX package, one
    twin each) runs the JAX script's commands, module for module, with the
    port's package in the module's place; a script that runs another runs
    the port's twin of it; the scene scripts export the same settings."""
    port_scripts = sorted(
        os.path.relpath(os.path.join(d, n), SCRIPTS)
        for d, _, names in os.walk(SCRIPTS) for n in names)
    assert len(port_scripts) == 4 + 8 and len(SCENES) == 8
    for rel in port_scripts:
        with open(os.path.join(SCRIPTS, rel)) as f:
            port = f.read()
        jax = _shell_lines(os.path.join(REPO, "scripts", rel))
        assert "iris_tpu." not in port.replace("iris_tpu_torch.", "")
        runs = [ln for ln in jax if "python -m" in ln
                or ln.startswith(("exec scripts/", "bash scripts/"))
                or " bash scripts/" in ln]
        assert runs, rel
        for ln in runs:
            assert ln.replace("iris_tpu.", "iris_tpu_torch.").replace(
                "scripts/", "iris_tpu_torch/scripts/") in port, (rel, ln)
        if rel.startswith("scenes/"):
            exports = [ln for ln in jax if ln.startswith("export ")]
            assert exports == [ln for ln in _shell_lines(
                os.path.join(SCRIPTS, rel)) if ln.startswith("export ")]
