"""Process set-up (optixpathtracer_tpu/runtime.py) and the entry points'
refusal to report a CPU run as a device run."""
import os

import jax
import pytest

from optixpathtracer_tpu import runtime


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert path == runtime.enable_compile_cache()  # no pid or time in it
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke
    with pytest.raises(chip_smoke.PhaseError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_card_info_names_the_card(gpu_device):
    info = runtime.card_info()
    assert "W" in info and gpu_device.device_kind.split()[0] in info
