"""UIMA type system + XMI serialization.

Completes the UIMA surface started in ``nlp/language_packs.py`` (CAS /
Annotation / AnalysisEngine): the reference vendors Apache UIMA in
``deeplearning4j-nlp-parent/deeplearning4j-nlp-uima`` whose two
interchange artifacts are the *type system descriptor* (XML) and *XMI*
(XML Metadata Interchange) CAS serialization. This module implements
both against the same in-memory CAS:

- ``TypeSystem``: named annotation types with single inheritance and
  typed features; ``validate`` checks a CAS against it.
- ``to_xmi`` / ``from_xmi``: round-trip a CAS through standards-shaped
  XMI (xmi:XMI envelope, ``cas:Sofa`` holding the document text,
  one element per annotation carrying ``xmi:id``/``begin``/``end`` and
  feature attributes).
- ``type_system_xml``: the descriptor XML for interchange with real UIMA
  installations.

Pure stdlib (xml.etree); no Java, no uimaj — the data formats are the
compatibility surface, not the JVM runtime.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.language_packs import CAS, Annotation

# the namespace URIs are part of the file format: the annotation types'
# URI is the JAX package's, so XMI moves between the two packages whole
_NS = {
    "xmi": "http://www.omg.org/XMI",
    "cas": "http:///uima/cas.ecore",
    "dl4j": "http:///deeplearning4j_tpu.ecore",
}
# the URI this package wrote before it took the reference's; still read
_OLD_DL4J_URIS = ("http:///deeplearning4j_tpu_torch.ecore",)


class TypeDescription:
    """One annotation type: name, supertype, feature -> range type."""

    def __init__(self, name: str, supertype: str = "uima.tcas.Annotation",
                 features: Optional[Dict[str, str]] = None):
        self.name = name
        self.supertype = supertype
        self.features = dict(features or {})


class TypeSystem:
    """Single-inheritance annotation type registry (the UIMA
    TypeSystemDescription analog)."""

    def __init__(self, types: Sequence[TypeDescription] = ()):
        self.types: Dict[str, TypeDescription] = {}
        for t in types:
            self.add(t)

    def add(self, t: TypeDescription) -> "TypeSystem":
        if t.name in self.types:
            raise ValueError(f"duplicate type {t.name!r}")
        self.types[t.name] = t
        return self

    def _chain(self, name: str) -> List[TypeDescription]:
        """Supertype chain with cycle detection (a hand-edited external
        descriptor can declare A<-B<-A; report it, don't hang)."""
        seen = set()
        chain = []
        while name in self.types:
            if name in seen:
                raise ValueError(f"type system has a supertype cycle at"
                                 f" {name!r}")
            seen.add(name)
            chain.append(self.types[name])
            name = self.types[name].supertype
        return chain

    def subsumes(self, ancestor: str, name: str) -> bool:
        if name == ancestor:
            return True
        return any(t.name == ancestor or t.supertype == ancestor
                   for t in self._chain(name))

    def features_of(self, name: str) -> Dict[str, str]:
        """Own + inherited features."""
        out: Dict[str, str] = {}
        for t in reversed(self._chain(name)):
            out.update(t.features)
        return out

    def validate(self, cas: CAS) -> List[str]:
        """Return problems (empty = valid): unknown types, unknown
        features, spans out of bounds."""
        problems = []
        n = len(cas.text)
        for tname in list(getattr(cas, "_by_type", {})):
            if tname not in self.types:
                problems.append(f"unknown type: {tname}")
                continue
            allowed = set(self.features_of(tname))
            for ann in cas.select(tname):
                if not (0 <= ann.begin <= ann.end <= n):
                    problems.append(
                        f"{tname} span [{ann.begin},{ann.end}) outside"
                        f" document of length {n}")
                for feat in ann.features:
                    if feat not in allowed:
                        problems.append(
                            f"{tname} has undeclared feature {feat!r}")
        return problems

    # ---- descriptor XML -------------------------------------------------
    def to_xml(self) -> str:
        root = ET.Element("typeSystemDescription")
        types_el = ET.SubElement(root, "types")
        for t in self.types.values():
            te = ET.SubElement(types_el, "typeDescription")
            ET.SubElement(te, "name").text = t.name
            ET.SubElement(te, "supertypeName").text = t.supertype
            if t.features:
                fs = ET.SubElement(te, "features")
                for fname, frange in t.features.items():
                    fe = ET.SubElement(fs, "featureDescription")
                    ET.SubElement(fe, "name").text = fname
                    ET.SubElement(fe, "rangeTypeName").text = frange
        return ET.tostring(root, encoding="unicode")

    @classmethod
    def from_xml(cls, xml: str) -> "TypeSystem":
        root = ET.fromstring(xml)
        ts = cls()
        for te in root.iter("typeDescription"):
            feats = {}
            for fe in te.iter("featureDescription"):
                feats[fe.findtext("name")] = fe.findtext("rangeTypeName")
            ts.add(TypeDescription(te.findtext("name"),
                                   te.findtext("supertypeName")
                                   or "uima.tcas.Annotation", feats))
        return ts


DEFAULT_TYPE_SYSTEM = TypeSystem([
    TypeDescription("sentence"),
    TypeDescription("token", features={"pos": "uima.cas.String",
                                       "lemma": "uima.cas.String"}),
])


import re as _re

_RESERVED_ATTRS = frozenset({"sofa", "begin", "end"})
_XML_NAME = _re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")


def to_xmi(cas: CAS) -> str:
    """Serialize a CAS to XMI: xmi:XMI envelope, cas:Sofa with the
    document text, one dl4j:<type> element per annotation. Feature names
    must be valid XML attribute names and may not shadow the reserved
    span attributes (sofa/begin/end) — violations raise rather than
    silently corrupting the spans."""
    for prefix, uri in _NS.items():
        ET.register_namespace(prefix, uri)
    root = ET.Element(f"{{{_NS['xmi']}}}XMI",
                      {f"{{{_NS['xmi']}}}version": "2.0"})
    next_id = 1
    sofa = ET.SubElement(root, f"{{{_NS['cas']}}}Sofa", {
        f"{{{_NS['xmi']}}}id": str(next_id),
        "sofaNum": "1",
        "sofaID": "_InitialView",
        "mimeType": "text",
        "sofaString": cas.text,
    })
    sofa_id = next_id
    next_id += 1
    for tname in sorted(getattr(cas, "_by_type", {})):
        for ann in cas.select(tname):
            attrs = {
                f"{{{_NS['xmi']}}}id": str(next_id),
                "sofa": str(sofa_id),
                "begin": str(ann.begin),
                "end": str(ann.end),
            }
            for k, v in ann.features.items():
                if k in _RESERVED_ATTRS or not _XML_NAME.match(k):
                    raise ValueError(
                        f"feature name {k!r} on {tname!r} cannot be "
                        "serialized to XMI (reserved or not a valid XML"
                        " attribute name)")
                attrs[k] = str(v)
            ET.SubElement(root, f"{{{_NS['dl4j']}}}{tname}", attrs)
            next_id += 1
    return ET.tostring(root, encoding="unicode")


def from_xmi(xml: str,
             type_system: Optional[TypeSystem] = None) -> CAS:
    """Parse XMI back into a CAS; validates against ``type_system`` when
    given (raises ValueError listing the problems)."""
    root = ET.fromstring(xml)
    sofa = root.find(f"{{{_NS['cas']}}}Sofa")
    if sofa is None:
        raise ValueError("XMI has no cas:Sofa element")
    text = sofa.get("sofaString", "")
    cas = CAS(text)
    reserved = {"sofa", "begin", "end"}
    for el in root:
        if el is sofa:
            continue
        uri, _, tname = el.tag[1:].partition("}")
        if not el.tag.startswith("{") or (
                uri != _NS["dl4j"] and uri not in _OLD_DL4J_URIS):
            continue
        begin = int(el.get("begin", 0))
        end = int(el.get("end", 0))
        feats = {k: v for k, v in el.attrib.items()
                 if k not in reserved and not k.startswith("{")}
        cas.add(Annotation(tname, begin, end, text[begin:end], **feats))
    if type_system is not None:
        problems = type_system.validate(cas)
        if problems:
            raise ValueError("XMI fails type-system validation: "
                             + "; ".join(problems))
    return cas
