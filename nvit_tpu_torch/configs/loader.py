"""Config loading: YAML defaults + .env files + NVIT_* environment overlay —
a copy of ``nvit_tpu/configs/loader.py``.

A copy, not an import: the module imports no jax, but it lives in the JAX
package, which the port does not load.  ``tests/test_torch_cli.py`` holds
``load_config`` equal to the JAX package's on the same files and
environment.  It reimplements the reference's Dynaconf contract without
Dynaconf:

* ``settings.yaml`` in the working directory, else the package's own copy
  (``configs/settings.yaml``), provides the default tree (sections: training / optimizer /
  model / system / wandb / data).
* a ``.env`` file in the working directory is loaded (``load_dotenv=True``).
* environment variables with the ``NVIT_`` prefix override nested keys with
  the ``NVIT_SECTION__KEY=value`` double-underscore syntax
  (e.g. ``NVIT_MODEL__USE_NVIT=true`` — see profiles/nvit1_k0.env).

The result is a typed, frozen `Config` dataclass rather than a dynamic object.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any

import yaml

from nvit_tpu_torch.configs.schema import Config, merge_dataclass

ENV_PREFIX = "NVIT"


def _parse_env_value(raw: str) -> Any:
    """Parse an env-var string the way Dynaconf would (bool/int/float/str)."""
    s = raw.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def read_dotenv(path: str | Path = ".env") -> dict[str, str]:
    """Minimal .env reader: KEY=VALUE lines, '#' comments, no interpolation."""
    path = Path(path)
    if not path.exists():
        return {}
    out: dict[str, str] = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        out[key.strip()] = value.strip().strip('"').strip("'")
    return out


def _env_overrides(env: dict[str, str]) -> dict[str, dict[str, Any]]:
    """Collect NVIT_SECTION__KEY=value pairs into a nested override dict."""
    tree: dict[str, dict[str, Any]] = {}
    prefix = ENV_PREFIX + "_"
    for key, raw in env.items():
        if not key.upper().startswith(prefix):
            continue
        rest = key[len(prefix):]
        parts = rest.split("__")
        if len(parts) < 2:
            continue  # e.g. NVIT_WANDB_API_KEY — secrets, not config-tree keys
        section = parts[0].lower()
        node = tree.setdefault(section, {})
        for p in parts[1:-1]:
            node = node.setdefault(p.lower(), {})
        node[parts[-1].lower()] = _parse_env_value(raw)
    return tree


def _normalize_section(section: str, values: dict[str, Any]) -> dict[str, Any]:
    """Adapt YAML quirks to the typed schema.

    The reference settings.yaml nests ``model.kohonen_scheduler.{enabled,...}``
    (settings.yaml:54-58) while the model dataclass uses flat
    ``kohonen_scheduler_*`` keys; the reference trainer never bridged the gap
    (train.py:398-417) — we do.
    """
    values = {k.lower(): v for k, v in values.items()}
    if section == "model" and isinstance(values.get("kohonen_scheduler"), dict):
        sched = values.pop("kohonen_scheduler")
        for k, v in sched.items():
            # setdefault: a flat NVIT_MODEL__KOHONEN_SCHEDULER_* env override
            # already in the merged tree must WIN over the YAML's nested
            # section (env > yaml precedence)
            values.setdefault(f"kohonen_scheduler_{k.lower()}", v)
    if section == "model":
        values.pop("scheduler", None)
    return values


def _deep_merge(base: dict[str, Any], extra: dict[str, Any]) -> dict[str, Any]:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


# flat secrets loaded from secrets.yaml (≙ the Dynaconf ``secrets=`` file,
# reference train.py:85-87); consulted by get_secret, never written back
_SECRETS: dict[str, str] = {}


def _load_secrets_file(path: str | Path) -> dict[str, Any]:
    """Read secrets.yaml: config-tree sections merge into the settings overlay;
    flat scalar keys (e.g. ``wandb_api_key``) go to the get_secret store."""
    path = Path(path)
    # each load_config reflects ONLY the current secrets file — without the
    # clear, a second load (different cwd / explicit path) would keep serving
    # the first file's flat keys through get_secret
    _SECRETS.clear()
    if not path.exists():
        return {}
    loaded = yaml.safe_load(path.read_text()) or {}
    tree: dict[str, Any] = {}
    for k, v in loaded.items():
        if isinstance(v, dict):
            tree[k.lower()] = v
        else:
            _SECRETS[str(k).upper()] = str(v)
    return tree


def load_config(
    settings_file: str | Path | None = "settings.yaml",
    *,
    dotenv_path: str | Path = ".env",
    secrets_file: str | Path = "secrets.yaml",
    env: dict[str, str] | None = None,
    overrides: dict[str, Any] | None = None,
) -> Config:
    """Build the Config: defaults ← YAML ← secrets ← .env ← process env ← overrides."""
    tree: dict[str, Any] = {}

    if settings_file is not None:
        path = Path(settings_file)
        if not path.exists():
            # fall back to the packaged defaults
            packaged = Path(__file__).parent / "settings.yaml"
            path = packaged if packaged.exists() else None  # type: ignore[assignment]
        if path is not None and path.exists():
            loaded = yaml.safe_load(path.read_text()) or {}
            tree = _deep_merge(tree, {k.lower(): v for k, v in loaded.items()})

    tree = _deep_merge(tree, _load_secrets_file(secrets_file))
    dotenv = read_dotenv(dotenv_path)
    tree = _deep_merge(tree, _env_overrides(dotenv))
    tree = _deep_merge(tree, _env_overrides(env if env is not None else dict(os.environ)))
    if overrides:
        tree = _deep_merge(tree, {k.lower(): v for k, v in overrides.items()})

    cfg = Config()
    changes: dict[str, Any] = {}
    for section in ("training", "optimizer", "model", "system", "wandb", "data"):
        if section in tree and isinstance(tree[section], dict):
            changes[section] = merge_dataclass(
                getattr(cfg, section), _normalize_section(section, tree[section])
            )
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    cfg.model.validate()
    cfg.optimizer.validate()
    return cfg


def get_secret(name: str, settings_env_key: str | None = None) -> str | None:
    """Secrets lookup: NVIT_<NAME> env var, then bare <NAME> env var, then the
    flat keys of ``secrets.yaml`` loaded by load_config.

    ≙ reference train.py:85-87, 514-515 (wandb key from secrets.yaml /
    NVIT_WANDB_API_KEY / WANDB_API_KEY).  We never write secrets to disk.
    """
    return (
        os.environ.get(f"{ENV_PREFIX}_{name}")
        or os.environ.get(settings_env_key or name)
        or _SECRETS.get(name.upper())
    )
