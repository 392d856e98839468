"""Two faults of the port's copied NLP modules, each with the test that
failed before its fix (ROADMAP.md queue 3, "Closed").

1. **XMI namespace** (``nlp/uima.py``). The annotation types' namespace
   URI is part of the file format. The port now writes the JAX
   package's URI, so an XMI written by either package reads back in the
   other with every annotation (before the fix: none, and no error),
   and it still reads files written under the URI it used before.
   The copied module's own cases (the type system, validation, reserved
   and invalid feature names) run here against the port.
2. **Bundled CJK dictionaries** (``nlp/language_packs.py``). The port
   ships byte-equal copies of the JAX package's ``nlp/data/*.gz`` and
   reads them from its own tree: in a directory holding the port and no
   JAX package, the tokenizers split as the JAX package's do (before the
   fix they fell back to their seed lists without a word). A missing
   bundled file raises ``FileNotFoundError``.
"""

import filecmp
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch.nlp import language_packs as tlp
from deeplearning4j_tpu_torch.nlp import uima as tu

REPO = Path(__file__).resolve().parents[1]
BUNDLED = ("chinese_freq.txt.gz", "japanese_pos.txt.gz",
           "japanese_words.txt.gz")
PROBES = ("北京大学的自然语言处理研究", "我们在北京学习 Python.",
          "東京は大きい都市です。", "私は日本語を勉強しています。")


def _cas(lp, text="Hello big world. Goodbye now."):
    cas = lp.AnalysisPipeline([lp.SentenceAnnotator(),
                               lp.TokenAnnotator()]).process(text)
    for i, tok in enumerate(cas.select("token")):
        tok.features["pos"] = "NN" if i % 2 else "VB"
    cas.add(lp.Annotation("entity", 6, 9, "big", id="e1"))
    return cas


def _annotations(cas):
    """(type, span, covered text, features) of every annotation; the
    covered text is the span's (XMI stores spans, not texts)."""
    return sorted((t, a.begin, a.end, cas.text[a.begin:a.end], tuple(
        sorted(a.features.items()))) for t in cas._by_type
        for a in cas.select(t))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_xmi_moves_between_the_packages_whole(writer):
    from deeplearning4j_tpu.nlp import language_packs as jlp
    from deeplearning4j_tpu.nlp import uima as ju
    w_lp, w_u, r_u = ((tlp, tu, ju) if writer == "port"
                      else (jlp, ju, tu))
    cas = _cas(w_lp)
    back = r_u.from_xmi(w_u.to_xmi(cas))
    assert back.text == cas.text
    assert len(_annotations(back)) == len(_annotations(cas)) == 8
    assert _annotations(back) == _annotations(cas)


def test_the_port_writes_the_reference_xmi():
    from deeplearning4j_tpu.nlp import language_packs as jlp
    from deeplearning4j_tpu.nlp import uima as ju
    xml = tu.to_xmi(_cas(tlp))
    assert xml == ju.to_xmi(_cas(jlp))
    assert 'xmlns:dl4j="http:///deeplearning4j_tpu.ecore"' in xml
    assert "deeplearning4j_tpu_torch" not in xml


def test_an_xmi_under_the_old_uri_still_reads_whole():
    cas = _cas(tlp)
    old = tu.to_xmi(cas).replace("http:///deeplearning4j_tpu.ecore",
                                 "http:///deeplearning4j_tpu_torch.ecore")
    assert "deeplearning4j_tpu_torch.ecore" in old
    back = tu.from_xmi(old)
    assert _annotations(back) == _annotations(cas)
    foreign = old.replace("http:///deeplearning4j_tpu_torch.ecore",
                          "http:///somebody.else.ecore")
    assert _annotations(tu.from_xmi(foreign)) == []


def test_type_system_subsumption_descriptor_and_validation():
    ts = tu.TypeSystem([
        tu.TypeDescription("entity", features={"id": "uima.cas.String"}),
        tu.TypeDescription("person", supertype="entity",
                           features={"role": "uima.cas.String"})])
    assert ts.subsumes("entity", "person")
    assert not ts.subsumes("person", "entity")
    assert set(ts.features_of("person")) == {"id", "role"}
    ts2 = tu.TypeSystem.from_xml(tu.DEFAULT_TYPE_SYSTEM.to_xml())
    assert set(ts2.types) == set(tu.DEFAULT_TYPE_SYSTEM.types)
    assert ts2.features_of("token")["pos"] == "uima.cas.String"
    cas = tlp.CAS("hi")
    cas.add(tlp.Annotation("token", 0, 9, "hi"))
    cas.add(tlp.Annotation("mystery", 0, 1, "h"))
    cas.add(tlp.Annotation("token", 0, 2, "hi", color="x"))
    assert len(tu.DEFAULT_TYPE_SYSTEM.validate(cas)) == 3
    with pytest.raises(ValueError, match="unknown type"):
        tu.from_xmi(tu.to_xmi(cas), tu.DEFAULT_TYPE_SYSTEM)
    cyc = tu.TypeSystem([tu.TypeDescription("a", supertype="b"),
                         tu.TypeDescription("b", supertype="a")])
    with pytest.raises(ValueError, match="cycle"):
        cyc.features_of("a")


def test_reserved_and_invalid_feature_names_are_refused():
    cas = tlp.CAS("abc")
    ann = tlp.Annotation("token", 0, 1, "a")
    ann.features["begin"] = "NN"
    cas.add(ann)
    with pytest.raises(ValueError, match="reserved"):
        tu.to_xmi(cas)
    cas2 = tlp.CAS("abc")
    cas2.add(tlp.Annotation("token", 0, 1, "a", **{"my pos": "NN"}))
    with pytest.raises(ValueError, match="XML attribute"):
        tu.to_xmi(cas2)
    with pytest.raises(ValueError, match="Sofa"):
        tu.from_xmi('<xmi:XMI xmlns:xmi="http://www.omg.org/XMI"/>')


@pytest.mark.parametrize("name", BUNDLED)
def test_bundled_files_are_the_references_bytes(name):
    port = REPO / "deeplearning4j_tpu_torch" / "nlp" / "data" / name
    ref = REPO / "deeplearning4j_tpu" / "nlp" / "data" / name
    assert Path(tlp._BUNDLED_DIR) == port.parent
    assert filecmp.cmp(port, ref, shallow=False)


@pytest.mark.parametrize("loader,name", [
    ("_load_bundled_freq", "chinese_freq.txt.gz"),
    ("_load_bundled_words", "japanese_words.txt.gz"),
    ("_load_bundled_pos", "japanese_pos.txt.gz")])
def test_a_missing_bundled_file_raises(monkeypatch, tmp_path, loader, name):
    fn = getattr(tlp, loader)
    assert len(fn(name)) > 100
    monkeypatch.setattr(tlp, "_BUNDLED_DIR", str(tmp_path))
    if hasattr(fn, "cache_clear"):
        fn.cache_clear()
    try:
        with pytest.raises(FileNotFoundError, match=name):
            fn(name)
    finally:
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


def test_tokenizers_without_the_jax_tree_match_jax(tmp_path):
    """The port alone in a directory tokenizes as the JAX package does."""
    from deeplearning4j_tpu.nlp import language_packs as jlp
    shutil.copytree(REPO / "deeplearning4j_tpu_torch",
                    tmp_path / "deeplearning4j_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json, sys\n"
            "from deeplearning4j_tpu_torch.nlp import language_packs as lp\n"
            "out = [[getattr(lp, f)().create(t).get_tokens() for t in "
            "json.loads(sys.argv[1])] for f in ('ChineseTokenizerFactory',"
            " 'JapaneseTokenizerFactory')]\n"
            "assert 'deeplearning4j_tpu' not in sys.modules\n"
            "print(json.dumps(out))\n")
    import json
    out = subprocess.run(
        [sys.executable, "-c", code, json.dumps(PROBES)], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tmp_path),
             "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    want = [[getattr(jlp, f)().create(t).get_tokens() for t in PROBES]
            for f in ("ChineseTokenizerFactory", "JapaneseTokenizerFactory")]
    assert got == want
    assert "北京大学" in got[0][0]
