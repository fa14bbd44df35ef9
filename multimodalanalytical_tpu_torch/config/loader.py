"""Minimal Hydra-compatible config composition.

The reference drives its whole replication surface through Hydra config
groups plus dotted CLI overrides (reference: configs/config_train.yaml:1-48,
cli/training.py:44-47, paper_replication/*/scripts/*.sh).  This module
re-implements the subset actually used there without the Hydra dependency:

  * a root config with a ``defaults`` list (``_self_`` + group selections),
  * config groups as YAML files under ``configs/<group>/...``,
  * ``${key}`` interpolation against the composed config,
  * dotted CLI overrides (``a.b.c=value``) and group overrides
    (``data=ir/patches``, ``mixture=ir/binary``, ``mixture=null``).

Composed configs are plain nested ``dict``/``list``/scalars.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import yaml


class ConfigError(ValueError):
    pass


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def load_yaml(path: Path) -> Any:
    with Path(path).open() as f:
        return yaml.safe_load(f)


def _deep_merge(base: Any, overlay: Any) -> Any:
    """Merge ``overlay`` into ``base`` recursively; overlay wins on conflicts."""
    if isinstance(base, dict) and isinstance(overlay, dict):
        merged = dict(base)
        for key, value in overlay.items():
            merged[key] = _deep_merge(base[key], value) if key in base else value
        return merged
    return overlay


def _set_dotted(config: Dict[str, Any], dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = config
    for key in keys[:-1]:
        if not isinstance(node, dict):
            raise ConfigError(f"Cannot descend into non-dict at '{key}' for '{dotted_key}'")
        if key not in node or node[key] is None:
            node[key] = {}
        node = node[key]
    if not isinstance(node, dict):
        raise ConfigError(f"Cannot set '{dotted_key}': parent is not a dict")
    node[keys[-1]] = value


def _get_dotted(config: Dict[str, Any], dotted_key: str) -> Any:
    node: Any = config
    for key in dotted_key.split("."):
        if not isinstance(node, dict) or key not in node:
            raise KeyError(dotted_key)
        node = node[key]
    return node


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value with YAML scalar semantics."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def parse_overrides(argv: List[str]) -> List[Tuple[str, Any, str, bool]]:
    """Parse ``key=value`` CLI arguments.

    Returns ``(key, value, raw_value, additive)`` tuples; raw value is kept
    so group selections (``data=ir/patches``) can use the unparsed string.
    ``additive`` is Hydra's ``+key=value`` form, which may introduce a key
    that does not exist in the composed config (a plain override of an
    unknown key is an error — it is almost always a typo).
    """
    overrides = []
    for arg in argv:
        if "=" not in arg:
            raise ConfigError(f"Override '{arg}' is not of the form key=value")
        key, raw = arg.split("=", 1)
        additive = key.startswith("+")
        key = key.lstrip("+")
        overrides.append((key, _parse_value(raw), raw, additive))
    return overrides


def _interpolate(node: Any, root: Dict[str, Any]) -> Any:
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        full = _INTERP_RE.fullmatch(node)
        if full:
            return _resolve_ref(full.group(1), root)

        def repl(match: "re.Match[str]") -> str:
            value = _resolve_ref(match.group(1), root)
            return "" if value is None else str(value)

        return _INTERP_RE.sub(repl, node)
    return node


def _resolve_ref(ref: str, root: Dict[str, Any]) -> Any:
    if ref.startswith("now:"):
        import datetime

        fmt = ref[len("now:"):]
        return datetime.datetime.now().strftime(fmt.replace("%%", "%"))
    try:
        value = _get_dotted(root, ref)
    except KeyError:
        raise ConfigError(f"Interpolation key '{ref}' not found")
    if isinstance(value, str) and _INTERP_RE.search(value):
        return _interpolate(value, root)
    return value


def _load_group_file(config_dir: Path, group: str, selection: str) -> Any:
    path = config_dir / group / f"{selection}.yaml"
    if not path.is_file():
        raise ConfigError(f"Config group file not found: {path}")
    return load_yaml(path)


def compose_config(
    config_dir: Path,
    config_name: str,
    overrides: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Compose a config like Hydra would.

    Args:
        config_dir: root of the config tree (e.g. ``configs/``).
        config_name: root config file name without extension.
        overrides: CLI-style ``key=value`` strings.
    """
    config_dir = Path(config_dir)
    root_path = config_dir / f"{config_name}.yaml"
    if not root_path.is_file():
        raise ConfigError(f"Root config not found: {root_path}")
    root_cfg = load_yaml(root_path) or {}
    defaults = root_cfg.pop("defaults", [])

    parsed = parse_overrides(list(overrides or []))

    # Group selections from the defaults list, overridable from the CLI.
    group_selections: Dict[str, Optional[str]] = {}
    self_seen = False
    ordered_groups: List[str] = []
    for entry in defaults:
        if entry == "_self_":
            self_seen = True
            continue
        if isinstance(entry, dict):
            for group, selection in entry.items():
                if isinstance(selection, list):
                    selection = selection[0] if selection else None
                group_selections[str(group)] = selection
                ordered_groups.append(str(group))
        else:
            group_selections[str(entry)] = None
            ordered_groups.append(str(entry))
    if not self_seen:
        ordered_groups = ordered_groups  # _self_ implicitly first

    # CLI group overrides: bare group name with a path-like or null value.
    remaining: List[Tuple[str, Any, bool]] = []
    for key, value, raw, additive in parsed:
        if "." not in key and key in group_selections:
            group_selections[key] = None if value is None else raw
        elif "." not in key and (config_dir / key).is_dir() and isinstance(value, str):
            group_selections[key] = raw
            ordered_groups.append(key)
        else:
            remaining.append((key, value, additive))

    config: Dict[str, Any] = copy.deepcopy(root_cfg)
    for group in ordered_groups:
        selection = group_selections.get(group)
        if selection is None:
            config.setdefault(group, None)
            continue
        content = _load_group_file(config_dir, group, str(selection))
        config[group] = _deep_merge(config.get(group), content)

    for key, value, additive in remaining:
        if not additive:
            # Hydra semantics: a plain override must target an existing key
            # (typos otherwise change nothing, silently); ``+key=value``
            # introduces new keys.
            try:
                _get_dotted(config, key)
            except KeyError:
                raise ConfigError(
                    f"Override '{key}' does not exist in the composed "
                    f"config (use '+{key}=...' to add a new key)"
                ) from None
        _set_dotted(config, key, value)

    return _interpolate(config, config)
