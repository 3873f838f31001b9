"""The port's configuration, its isolation from JAX and the JAX package,
and its device rule: entry points run on the card unless told otherwise."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_moe, tiny_ssm
from repro.configs import ARCH_IDS, get_config, list_archs
import repro_torch.configs as tconfigs
import repro_torch.models as tm

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("maker", [tiny_moe, tiny_dense, tiny_ssm],
                         ids=["tiny_moe", "tiny_dense", "tiny_ssm"])
def test_model_config_fields_and_helpers_equal(maker):
    cfg = maker()
    tcfg = tm.ModelConfig(**_fields(cfg))
    assert _fields(tcfg) == _fields(cfg)
    assert tcfg.layer_kinds() == cfg.layer_kinds()
    assert tcfg.pattern() == cfg.pattern()
    assert tcfg.d_expert_resolved == cfg.d_expert_resolved
    assert tcfg.num_experts_padded == cfg.num_experts_padded
    assert _fields(tcfg.reduced()) == _fields(cfg.reduced())


@pytest.mark.parametrize("arch", list_archs())
def test_registry_configs_equal_field_by_field(arch):
    cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    assert [f.name for f in dataclasses.fields(tcfg)] == \
        [f.name for f in dataclasses.fields(cfg)]
    assert _fields(tcfg) == _fields(cfg)
    assert _fields(tcfg.reduced()) == _fields(cfg.reduced())
    assert tcfg.pattern() == cfg.pattern()
    assert tcfg.param_count() == cfg.param_count()


def test_registry_lists_match():
    assert tconfigs.ARCH_IDS == ARCH_IDS
    assert tconfigs.list_archs() == list_archs()
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-model")


def test_import_leaves_jax_and_repro_out():
    """Importing every module of the port loads neither ``jax`` nor the
    JAX package ``repro``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "n = sum(1 for k in sys.modules if k.startswith('repro_torch'))\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True).stdout.split(maxsplit=1)
    assert int(out[0]) > 20
    assert out[1].strip() == "[]"


def test_entry_points_default_to_the_card():
    """Without ``device``, each entry point asks for CUDA and raises on a
    host that has none; ``device="cpu"`` is the explicit opt-in."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from repro_torch.launch.serve import main
    cfg = tm.ModelConfig(**_fields(tiny_moe()))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.from_numpy({"w": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--tokens", "2"])
    params = tm.init_params(cfg, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"


def test_serve_cli_runs_on_the_host_when_asked(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--tokens", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "tokens == dense reference (same transport policy): True" in out
    assert "measured wall time per decoded token on cpu" in out


def test_unported_models_raise_not_implemented():
    """The encoder-decoder and frontend families were the last models the
    port refused; now ``init_params`` of their reduced configs builds the
    reference's parameter tree (keys, shapes and dtypes from
    ``jax.eval_shape``, so nothing compiles), and only the engine refuses
    an encoder-decoder config, with the reference's ``ValueError``."""
    import jax
    from repro.models import init_params as jinit
    from repro_torch.core import ODMoEEngine
    for arch in ("seamless-m4t-large-v2", "internvl2-26b"):
        cfg = get_config(arch).reduced()
        want = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
        got = tm.init_params(tconfigs.get_config(arch).reduced(), device="cpu")
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [jax.tree_util.keystr(p) for p, _ in flat_got] == \
            [jax.tree_util.keystr(p) for p, _ in flat_want]
        assert [tuple(t.shape) for _, t in flat_got] == [tuple(s.shape) for _, s in flat_want]
        assert {t.dtype for _, t in flat_got} == {torch.float32}
    seamless = tconfigs.get_config("seamless-m4t-large-v2").reduced()
    params = tm.init_params(seamless, device="cpu")
    with pytest.raises(ValueError, match="engine drives decoder-only models"):
        ODMoEEngine(seamless, params, device="cpu")
