"""Dashboard internationalization (reference:
deeplearning4j-ui-parent/deeplearning4j-play/.../i18n/I18NProvider.java +
DefaultI18N.java, which read per-language message bundles for the Play
templates).

Here the bundles are in-code maps (the reference ships
``messages_*.properties`` resources); ``I18N.get_instance()`` is the
provider singleton, ``get_message(key, lang)`` the lookup with
English fallback, and the server substitutes ``{{i18n:key}}``
placeholders in the page per-request (``?lang=xx``) — the same
template-substitution job Play's message interpolation does.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Optional

DEFAULT_LANGUAGE = "en"

_PLACEHOLDER = re.compile(r"\{\{i18n:([a-zA-Z0-9_.]+)\}\}")

_BUNDLES: Dict[str, Dict[str, str]] = {
    "en": {
        "train.nav.overview": "Overview",
        "train.nav.model": "Model",
        "train.nav.system": "System",
        "train.nav.activations": "Activations",
        "train.nav.tsne": "t-SNE",
        "train.nav.evaluation": "Evaluation",
        "train.overview.title": "Training overview",
        "train.overview.score": "Score vs iteration",
        "train.overview.throughput": "Samples/sec",
        "train.model.title": "Model graph",
        "train.system.title": "System",
        "train.activations.title": "Layer activations",
        "train.evaluation.title": "Evaluation",
    },
    "ja": {
        "train.nav.overview": "概要",
        "train.nav.model": "モデル",
        "train.nav.system": "システム",
        "train.nav.activations": "活性化",
        "train.nav.tsne": "t-SNE",
        "train.nav.evaluation": "評価",
        "train.overview.title": "トレーニング概要",
        "train.overview.score": "スコア/イテレーション",
        "train.overview.throughput": "サンプル/秒",
        "train.model.title": "モデルグラフ",
        "train.system.title": "システム",
        "train.activations.title": "レイヤー活性化",
        "train.evaluation.title": "評価",
    },
    "de": {
        "train.nav.overview": "Übersicht",
        "train.nav.model": "Modell",
        "train.nav.system": "System",
        "train.nav.activations": "Aktivierungen",
        "train.nav.tsne": "t-SNE",
        "train.nav.evaluation": "Auswertung",
        "train.overview.title": "Trainingsübersicht",
        "train.overview.score": "Score je Iteration",
        "train.overview.throughput": "Beispiele/Sekunde",
        "train.model.title": "Modellgraph",
        "train.system.title": "System",
        "train.activations.title": "Schicht-Aktivierungen",
        "train.evaluation.title": "Auswertung",
    },
}


class I18N:
    """DefaultI18N analog: singleton provider with a default language
    and per-key English fallback."""

    _instance: Optional["I18N"] = None

    def __init__(self):
        self.default_language = DEFAULT_LANGUAGE

    @classmethod
    def get_instance(cls) -> "I18N":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def languages(self):
        return sorted(_BUNDLES)

    def set_default_language(self, lang: str):
        if lang not in _BUNDLES:
            raise ValueError(f"unknown language {lang!r}; have "
                             f"{self.languages()}")
        self.default_language = lang

    def resolve_language(self, lang: Optional[str]) -> str:
        """The language actually served: unknown/absent codes fall back
        to the default (clients must see the EFFECTIVE language, not an
        echo of what they asked for)."""
        if lang and lang in _BUNDLES:
            return lang
        return self.default_language

    def get_message(self, key: str, lang: Optional[str] = None) -> str:
        bundle = _BUNDLES[self.resolve_language(lang)]
        return bundle.get(key, _BUNDLES[DEFAULT_LANGUAGE].get(key, key))

    def messages(self, lang: Optional[str] = None) -> Dict[str, str]:
        out = dict(_BUNDLES[DEFAULT_LANGUAGE])
        out.update(_BUNDLES[self.resolve_language(lang)])
        return out

    def render(self, template: str, lang: Optional[str] = None) -> str:
        """Substitute ``{{i18n:key}}`` placeholders (cached per
        language — the bundles and template are static)."""
        return _render_cached(self, template, self.resolve_language(lang))


@functools.lru_cache(maxsize=16)
def _render_cached(i18n: "I18N", template: str, lang: str) -> str:
    return _PLACEHOLDER.sub(
        lambda m: i18n.get_message(m.group(1), lang), template)
