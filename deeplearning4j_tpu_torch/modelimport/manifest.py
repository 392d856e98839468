"""Executable supported-layer manifest.

A copy of the JAX package's ``modelimport/manifest.py`` over the port's
converter registry: ``render_markdown()`` gives the same table for the
same fixtures.

The reference's supported-layer contract lives in
KerasLayer.java's registry + the committed resources of
KerasModelEndToEndTest; here it is executable: ``coverage()`` walks the
COMMITTED fixture corpus (tests/resources/keras), reads each archive's
model config, and maps every supported Keras class name to the e2e
fixtures that exercise it. ``uncovered()`` must stay empty — enforced
by tests/test_torch_keras_fixtures.py, so a new
converter cannot land without a fixture.

Alias handling is DERIVED, not hand-maintained: registry names that
dispatch to the same converter function (Keras-1-era spellings,
lowercase functional ops) form one coverage group — a fixture
exercising any member covers them all. The K1 *dialect* config keys
those aliases carry (nb_filter/border_mode/...) are themselves
exercised by the K1 fixtures (k1_mlp, k1_cnn_atrous, k1_lstm,
k1_merge).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, List, Optional, Set

DEFAULT_FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "resources", "keras")


def supported_layers() -> List[str]:
    """Every Keras class name the importer accepts, builtin + custom."""
    from deeplearning4j_tpu_torch.modelimport.layers import _CUSTOM, CONVERTERS
    return sorted(set(CONVERTERS) | set(_CUSTOM))


def _alias_groups() -> Dict[str, Set[str]]:
    """class name → all registry names sharing its converter function."""
    from deeplearning4j_tpu_torch.modelimport.layers import CONVERTERS
    by_fn: Dict[int, Set[str]] = {}
    for name, fn in CONVERTERS.items():
        if fn is None:       # K1 'Merge': mode-resolved, its own group
            continue
        by_fn.setdefault(id(fn), set()).add(name)
    out: Dict[str, Set[str]] = {}
    for group in by_fn.values():
        for name in group:
            out[name] = group
    return out


def _layer_classes(cfg) -> Set[str]:
    out: Set[str] = set()

    def walk(c):
        if isinstance(c, dict):
            cn = c.get("class_name")
            if cn and isinstance(c.get("config"), (dict, list)):
                if cn not in ("Sequential", "Model", "Functional"):
                    out.add(cn)
                walk(c.get("config"))
            else:
                for v in c.values():
                    walk(v)
        elif isinstance(c, (list, tuple)):
            for v in c:
                walk(v)

    walk(cfg)
    return out


def fixture_layer_classes(path: str) -> Set[str]:
    """Class names appearing in one committed fixture archive."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"PK\x03\x04":                       # .keras zip
        with zipfile.ZipFile(path) as z:
            cfg = json.loads(z.read("config.json"))
    else:                                            # legacy .h5
        import h5py
        with h5py.File(path, "r") as f:
            raw = f.attrs["model_config"]
            if isinstance(raw, bytes):
                raw = raw.decode()
            cfg = json.loads(raw)
    return _layer_classes(cfg)


def _by_class(fixture_dir: str) -> Dict[str, Set[str]]:
    """class name → fixture names containing it, over the corpus dir."""
    by_class: Dict[str, Set[str]] = {}
    for fn in sorted(os.listdir(fixture_dir)):
        if not (fn.endswith(".h5") or fn.endswith(".keras")):
            continue
        name = fn.rsplit(".", 1)[0]
        for cls in fixture_layer_classes(os.path.join(fixture_dir, fn)):
            by_class.setdefault(cls, set()).add(name)
    return by_class


def coverage(fixture_dir: str = DEFAULT_FIXTURE_DIR,
             by_class: Optional[Dict[str, Set[str]]] = None
             ) -> Dict[str, List[str]]:
    """supported class name → sorted fixtures exercising it (directly,
    or via any registry name sharing the converter function).
    ``by_class`` lets callers that already walked the corpus reuse it."""
    if by_class is None:
        by_class = _by_class(fixture_dir)
    groups = _alias_groups()
    out: Dict[str, List[str]] = {}
    for cls in supported_layers():
        names: Set[str] = set()
        for member in groups.get(cls, {cls}):
            names |= by_class.get(member, set())
        out[cls] = sorted(names)
    return out


def uncovered(fixture_dir: str = DEFAULT_FIXTURE_DIR) -> List[str]:
    """Supported class names with NO e2e fixture — the contract is that
    this stays empty."""
    return sorted(cls for cls, fixtures in coverage(fixture_dir).items()
                  if not fixtures)


def render_markdown(fixture_dir: str = DEFAULT_FIXTURE_DIR) -> str:
    """The docs table: every supported layer with its fixture evidence
    (docs render from the same code path the test enforces)."""
    by_class = _by_class(fixture_dir)
    groups = _alias_groups()
    lines = ["| Keras layer | e2e fixtures |", "|---|---|"]
    for cls, fixtures in coverage(fixture_dir, by_class).items():
        note = ""
        if not by_class.get(cls):
            direct = sorted(n for n in groups.get(cls, set())
                            if by_class.get(n))
            if direct:
                note = f" *(alias of {'/'.join(direct)})*"
        lines.append(f"| {cls}{note} | {', '.join(fixtures) or '—'} |")
    return "\n".join(lines)
