"""The port's tuning registry (allpathslg_tpu_torch/tuning.py) against the
reference's rules (allpathslg_tpu/tuning.py): the env var APLG_<KEY>
first, then the per-user file ($APLG_TUNING_FILE), then the repo file next
to the module, then DEFAULTS; `save` writes the per-user file only and
clears the cached load."""

import json
from pathlib import Path

import pytest

from allpathslg_tpu_torch import tuning

REPO_FILE = Path(tuning.__file__).with_name("kernel_tuning.json")


@pytest.fixture
def registry(monkeypatch, tmp_path):
    """A per-user file under tmp_path, no env override, a fresh cache."""
    monkeypatch.delenv("APLG_COUNT_ENGINE", raising=False)
    user = tmp_path / "user" / "kernel_tuning.json"
    monkeypatch.setenv("APLG_TUNING_FILE", str(user))
    tuning._load.cache_clear()
    yield user
    tuning._load.cache_clear()


def test_repo_file_says_flat():
    assert json.loads(REPO_FILE.read_text()) == {"count_engine": "flat"}
    assert tuning.DEFAULTS == {"count_engine": "flat"}


@pytest.mark.parametrize("env,user,repo,want", [
    ("bucketed", "flat", "flat", "bucketed"),     # env first
    (None, "bucketed", "flat", "bucketed"),       # then the user file
    (None, None, "bucketed", "bucketed"),         # then the repo file
    (None, None, None, "flat"),                   # then DEFAULTS
    ("flat", "bucketed", "bucketed", "flat"),
])
def test_precedence(registry, monkeypatch, tmp_path, env, user, repo, want):
    if env is not None:
        monkeypatch.setenv("APLG_COUNT_ENGINE", env)
    if user is not None:
        registry.parent.mkdir(parents=True)
        registry.write_text(json.dumps({"count_engine": user}))
    repo_file = tmp_path / "repo_kernel_tuning.json"
    if repo is not None:
        repo_file.write_text(json.dumps({"count_engine": repo}))
    monkeypatch.setattr(tuning, "_REPO_DEFAULTS_FILE", str(repo_file))
    assert tuning.get("count_engine") == want


def test_default_user_file_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("APLG_TUNING_FILE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tuning._user_file() == str(
        tmp_path / ".cache" / "allpathslg_tpu_torch" / "kernel_tuning.json")


def test_save_writes_only_the_user_file(registry):
    before = REPO_FILE.read_bytes()
    assert tuning.get("count_engine") == "flat"     # cached: repo default
    path = tuning.save({"count_engine": "bucketed"})
    assert path == str(registry)
    assert json.loads(registry.read_text()) == {"count_engine": "bucketed"}
    assert REPO_FILE.read_bytes() == before
    # the cache was cleared: the saved winner is read at once
    assert tuning.get("count_engine") == "bucketed"
    tuning.save({"other": 1})                       # merges, keeps the rest
    assert json.loads(registry.read_text()) == {"count_engine": "bucketed",
                                                "other": 1}
