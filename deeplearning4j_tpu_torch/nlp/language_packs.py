"""Language-pack tokenizers: Chinese, Japanese, Korean, and a UIMA-style
annotator pipeline.

Analogs of the reference's per-language NLP modules (SURVEY §2.7):
``deeplearning4j-nlp-chinese`` (vendored Ansj segmenter),
``-japanese`` (Kuromoji), ``-korean`` (KoreanAnalyzer twitter-text), and
``-uima`` (UIMA annotator pipeline). Those modules vendor large
dictionary-driven analyzers; here each language gets a self-contained
statistical/rule segmenter with the same ``TokenizerFactory`` contract, so
``Word2Vec``/``SequenceVectors`` pipelines work identically across
languages. A user-supplied dictionary (one word per line, cached under
``DL4J_TPU_DATA_DIR``) upgrades segmentation quality without code changes
— the same posture as the dataset fetchers' cache contract.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, List, NamedTuple, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.tokenization import (
    Tokenizer,
    TokenizerFactory,
)

_DATA_DIR = os.environ.get("DL4J_TPU_DATA_DIR",
                           os.path.expanduser("~/.deeplearning4j_tpu/data"))


def _load_dict(name: str) -> Optional[set]:
    path = os.path.join(_DATA_DIR, "dicts", name)
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return {line.strip() for line in f if line.strip()}
    return None


# the bundled dictionaries: copies of the JAX package's data files, byte
# for byte, shipped in this package's nlp/data/
_BUNDLED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data")


def _bundled_path(name: str) -> str:
    """The path of bundled file ``name``; a missing one raises (the
    tokenizers would otherwise split differently without a word)."""
    path = os.path.join(_BUNDLED_DIR, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"bundled dictionary {name} is missing from {_BUNDLED_DIR}")
    return path


import functools


@functools.lru_cache(maxsize=4)
def _load_bundled_freq(name: str) -> dict:
    """Bundled gzipped frequency dictionary ("word log_freq" per line) —
    generated by nlp/data/gen_dicts.py from permissively-licensed word
    lists (jieba's MIT dict for Chinese); the answer to the
    reference's vendored Ansj/Kuromoji dictionaries. Cached: 60k lines
    per parse, and callers copy before mutating."""
    import gzip
    out = {}
    with gzip.open(_bundled_path(name), "rt", encoding="utf-8") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == 2:
                out[parts[0]] = float(parts[1])
            elif len(parts) == 1:
                out[parts[0]] = 0.0
    return out


@functools.lru_cache(maxsize=4)
def _load_bundled_words(name: str) -> frozenset:
    import gzip
    with gzip.open(_bundled_path(name), "rt", encoding="utf-8") as fh:
        return frozenset(line.strip() for line in fh if line.strip())


# ---------------------------------------------------------------------------
# Chinese — forward maximum matching over a dictionary, char fallback
# (reference: deeplearning4j-nlp-chinese vendored Ansj)
# ---------------------------------------------------------------------------

_CJK = r"一-鿿㐀-䶿"
# minimal seed vocabulary of common multi-char words so the segmenter is
# useful out of the box; a cached dict file extends it
_ZH_SEED = {
    "中国", "我们", "你们", "他们", "什么", "没有", "可以", "自己",
    "现在", "知道", "时候", "学习", "机器", "深度", "神经", "网络",
    "模型", "数据", "训练", "人工", "智能", "因为", "所以", "如果",
    "但是", "就是", "这个", "那个", "已经", "还是", "或者", "今天",
    "明天", "问题", "工作", "生活", "世界", "非常", "喜欢", "谢谢",
    # high-frequency everyday vocabulary
    "时间", "地方", "东西", "事情", "朋友", "老师", "学生", "学校",
    "公司", "国家", "城市", "北京", "上海", "电话", "电脑", "手机",
    "电视", "电影", "音乐", "新闻", "报纸", "文章", "历史", "文化",
    "经济", "政治", "社会", "科学", "技术", "发展", "研究", "教育",
    "医院", "医生", "健康", "身体", "运动", "比赛", "足球", "篮球",
    "飞机", "火车", "汽车", "地铁", "公共", "交通", "旅游", "旅行",
    "天气", "下雨", "下雪", "春天", "夏天", "秋天", "冬天", "早上",
    "中午", "晚上", "昨天", "后天", "星期", "月份", "去年", "明年",
    "大家", "别人", "先生", "小姐", "孩子", "父母", "家庭", "房子",
    "厨房", "商店", "超市", "市场", "银行", "钱包", "价格", "便宜",
    "开始", "结束", "继续", "停止", "出发", "到达", "回来", "离开",
    "认识", "了解", "理解", "记得", "忘记", "希望", "觉得", "认为",
    "应该", "必须", "需要", "帮助", "感谢", "对不起", "再见", "欢迎",
    "高兴", "快乐", "幸福", "难过", "生气", "害怕", "担心", "放心",
    "重要", "主要", "特别", "一般", "普通", "简单", "复杂", "容易",
    "困难", "方便", "安全", "危险", "干净", "漂亮", "好看", "有趣",
    "有名", "著名", "年轻", "聪明", "努力", "认真", "热情", "友好",
    "计算", "程序", "软件", "系统", "信息", "互联网", "网站", "网上",
    "语言", "文字", "汉语", "英语", "翻译", "词典", "意思", "内容",
    "方法", "办法", "结果", "原因", "影响", "变化", "情况", "环境",
    "大学", "中学", "小学", "处理", "分析", "设计", "管理", "服务",
    "自然", "动物", "植物", "森林", "河流", "海洋", "太阳", "月亮",
    "星星", "地球", "宇宙", "空气", "能源", "资源", "保护", "污染",
}


class ChineseTokenizerFactory(TokenizerFactory):
    """Frequency-driven unigram segmenter (reference:
    ChineseTokenizerFactory over the vendored Ansj analyzer). Round 3
    bundles a 60k-entry frequency dictionary (built from jieba's
    MIT-licensed dict.txt — nlp/data/gen_dicts.py) and segments each CJK
    run by dynamic programming over the max-log-frequency path — the
    standard unigram LM decode, which resolves overlap ambiguities
    forward-maximum-matching gets wrong. Unmatched characters fall back
    to singletons with a penalty; Latin/digit runs stay whole. A cached
    ``dicts/chinese.txt`` and the ``dictionary`` argument extend the
    vocabulary (at a default mid-range frequency)."""

    # scores are normalized log-probabilities (see gen_dicts.py); the
    # rarest bundled word sits near -16.6, so a lone character costs
    # more than any word and user/seed entries price like mid-frequency
    # words (beating their own character/sub-word splits)
    _CHAR_SCORE = -20.0
    _USER_SCORE = -8.0

    def __init__(self, dictionary: Optional[Iterable[str]] = None):
        super().__init__()
        freq = dict(_load_bundled_freq("chinese_freq.txt.gz"))
        for w in _ZH_SEED:
            freq.setdefault(w, self._USER_SCORE)
        for w in (_load_dict("chinese.txt") or ()):
            freq.setdefault(w, self._USER_SCORE)
        for w in (dictionary or ()):
            freq[w] = max(freq.get(w, self._USER_SCORE),
                          self._USER_SCORE)
        self._freq = freq
        self._dict = set(freq)
        self._max_len = max((len(w) for w in freq), default=1)
        self._scanner = re.compile(
            rf"([{_CJK}]+)|([A-Za-z0-9]+)|(\S)")

    def _segment_cjk(self, run: str) -> List[str]:
        n = len(run)
        best = [0.0] + [float("-inf")] * n    # best[i]: score of run[:i]
        back = [0] * (n + 1)
        maxl = min(self._max_len, n)
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            # single characters: dictionary price when known (seed/user
            # entries may be single-char), else the fallback penalty
            s = best[i] + self._freq.get(run[i], self._CHAR_SCORE)
            if s > best[i + 1]:
                best[i + 1] = s
                back[i + 1] = i
            for l in range(2, min(maxl, n - i) + 1):
                w = run[i:i + l]
                f = self._freq.get(w)
                if f is not None and best[i] + f > best[i + l]:
                    best[i + l] = best[i] + f
                    back[i + l] = i
        out: List[str] = []
        i = n
        while i > 0:
            j = back[i]
            out.append(run[j:i])
            i = j
        out.reverse()
        return out

    def create(self, sentence: str) -> Tokenizer:
        tokens: List[str] = []
        for cjk, latin, other in self._scanner.findall(sentence):
            if cjk:
                tokens.extend(self._segment_cjk(cjk))
            elif latin:
                tokens.append(latin)
        return Tokenizer(tokens, self._pre)


# ---------------------------------------------------------------------------
# Japanese — script-transition segmentation (reference:
# deeplearning4j-nlp-japanese vendored Kuromoji)
# ---------------------------------------------------------------------------

_HIRA = r"぀-ゟ"
_KATA = r"゠-ヿㇰ-ㇿ"

# common kanji compounds so compound splitting works out of the box; a
# cached ``japanese.txt`` (Kuromoji/mecab-style word list) extends it
_JA_SEED = {
    "日本", "日本語", "東京", "会社", "仕事", "学校", "学生", "先生",
    "電話", "電車", "時間", "今日", "明日", "昨日", "今年", "去年",
    "毎日", "毎週", "午前", "午後", "世界", "国家", "社会", "経済",
    "政治", "歴史", "文化", "科学", "技術", "研究", "開発", "教育",
    "大学", "高校", "問題", "質問", "答え", "言葉", "文章", "意味",
    "情報", "新聞", "映画", "音楽", "写真", "料理", "食事", "朝食",
    "昼食", "夕食", "天気", "天気予報", "旅行", "観光", "案内",
    "家族", "友達", "子供", "両親", "兄弟", "姉妹", "結婚", "誕生日",
    "病院", "医者", "健康", "運動", "練習", "試験", "試合", "勉強",
    "機械", "学習", "機械学習", "人工", "知能", "人工知能", "深層",
    "自然", "言語", "処理", "自然言語", "計算", "計算機", "電脳",
    "銀行", "会議", "書類", "説明", "説明書", "住所", "名前", "番号",
}


class JapaneseToken(NamedTuple):
    """Kuromoji Token analog: surface + coarse ipadic part-of-speech
    (名詞/動詞/助詞/形容詞/助動詞/...) + katakana reading when known."""
    surface: str
    part_of_speech: str
    reading: Optional[str]


@functools.lru_cache(maxsize=2)
def _load_bundled_pos(name: str) -> dict:
    """surface → (coarse POS, reading or '*') from the bundled lexicon
    (generated by nlp/data/gen_dicts.py from the ipadic fixture)."""
    import gzip
    out = {}
    with gzip.open(_bundled_path(name), "rt", encoding="utf-8") as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 3:
                out[parts[0]] = (parts[1], parts[2])
    return out


class JapaneseTokenizerFactory(TokenizerFactory):
    """Segments on script transitions (kanji→hiragana starts a new
    content+inflection unit; katakana runs and Latin runs are single
    tokens), with hiragana particles split off. This is the classic
    "tiny segmenter" heuristic family; a cached ``japanese.txt``
    dictionary refines kanji compound splits via maximum matching."""

    _PARTICLES = {"は", "が", "を", "に", "へ", "と", "で", "の", "も",
                  "や", "から", "まで", "より", "ね", "よ", "か", "な"}

    def __init__(self, dictionary: Optional[Iterable[str]] = None):
        super().__init__()
        d = set(_JA_SEED)
        # bundled real-text vocabulary (nlp/data/gen_dicts.py: surface
        # forms from the ipadic tokenization of the public-domain novel
        # "Botchan" — the fixture the reference's Kuromoji port tests
        # against), so compound splitting works out of the box
        d |= _load_bundled_words("japanese_words.txt.gz")
        d |= set(_load_dict("japanese.txt") or ())
        if dictionary:
            d |= set(dictionary)
        self._dict = d
        self._max_len = max((len(w) for w in self._dict), default=1)
        self._scanner = re.compile(
            rf"([{_CJK}]+[{_HIRA}]*)|([{_KATA}]+)|([{_HIRA}]+)"
            rf"|([A-Za-z0-9]+)|(\S)")

    def _split_compound(self, run: str) -> List[str]:
        """Maximum-matching split of a kanji(+inflection) run against the
        dictionary; the whole run stays one token when nothing matches."""
        if not self._dict:
            return [run]
        out: List[str] = []
        buf = ""  # unmatched span stays one token, not per-char
        i, n = 0, len(run)
        while i < n:
            for l in range(min(self._max_len, n - i), 1, -1):
                if run[i:i + l] in self._dict:
                    if buf:
                        out.append(buf)
                        buf = ""
                    out.append(run[i:i + l])
                    i += l
                    break
            else:
                buf += run[i]
                i += 1
        if buf:
            out.append(buf)
        return out

    def _split_particles(self, run: str) -> List[str]:
        # peel trailing particles off a hiragana run, longest first
        out: List[str] = []
        while run:
            for l in (2, 1):
                if len(run) > l and run[-l:] in self._PARTICLES:
                    out.insert(0, run[-l:])
                    run = run[:-l]
                    break
            else:
                out.insert(0, run)
                break
        return out

    def create(self, sentence: str) -> Tokenizer:
        tokens: List[str] = []
        for kanji_mix, kata, hira, latin, _other in \
                self._scanner.findall(sentence):
            if kanji_mix:
                tokens.extend(self._split_compound(kanji_mix))
            elif kata:
                tokens.append(kata)
            elif hira:
                tokens.extend(self._split_particles(hira))
            elif latin:
                tokens.append(latin)
        return Tokenizer(tokens, self._pre)

    # ---- morphological analysis (round 5, VERDICT r4 missing #4) ----
    # Kuromoji exposes Token.getPartOfSpeech()/getReading()
    # (com/atilika/kuromoji/ipadic/Token.java); the analog: a bundled
    # surface→(coarse ipadic POS, katakana reading) lexicon generated
    # from the same ipadic fixture as the word list
    # (nlp/data/gen_dicts.py gen_japanese_pos), with script-shape
    # heuristics for out-of-lexicon tokens.

    _VERB_ENDINGS = ("る", "た", "て", "ます", "ました", "ません",
                     "す", "く", "ぐ", "つ", "ぬ", "ぶ", "む", "う")

    def _guess_pos(self, tok: str) -> str:
        if tok in self._PARTICLES:
            return "助詞"
        first = tok[0]
        if "぀" <= first <= "ゟ":                     # hiragana run
            return ("動詞" if tok.endswith(self._VERB_ENDINGS)
                    else "名詞")
        if "゠" <= first <= "ヿ" or "ㇰ" <= first <= "ㇿ":
            return "名詞"                              # katakana loanword
        if tok.endswith("い") and len(tok) > 1:
            return "形容詞"                            # kanji + い
        if tok[-1:] >= "぀" and tok[-1:] <= "ゟ" and \
                tok.endswith(self._VERB_ENDINGS):
            return "動詞"                              # kanji + okurigana
        return "名詞"

    def analyze(self, sentence: str) -> List["JapaneseToken"]:
        """Tokenize + tag: Kuromoji's Tokenizer.tokenize() analog.
        Lexicon surfaces carry their ipadic coarse POS and katakana
        reading; out-of-lexicon tokens get script-heuristic POS and, for
        katakana runs, the run itself as the reading."""
        lex = _load_bundled_pos("japanese_pos.txt.gz")
        out: List[JapaneseToken] = []
        for tok in self.create(sentence).get_tokens():
            hit = lex.get(tok)
            if hit is not None:
                pos, reading = hit
                out.append(JapaneseToken(
                    tok, pos, None if reading == "*" else reading))
                continue
            pos = self._guess_pos(tok)
            first = tok[0]
            reading = tok if ("゠" <= first <= "ヿ"
                              or "ㇰ" <= first <= "ㇿ") else None
            out.append(JapaneseToken(tok, pos, reading))
        return out


# ---------------------------------------------------------------------------
# Korean — whitespace eojeol + particle (josa) stripping (reference:
# deeplearning4j-nlp-korean KoreanAnalyzer)
# ---------------------------------------------------------------------------


class KoreanTokenizerFactory(TokenizerFactory):
    """Splits on whitespace into eojeol, then strips common trailing
    particles (josa) so inflected forms share a stem token."""

    _JOSA = ("은", "는", "이", "가", "을", "를", "에", "의", "도",
             "으로", "로", "와", "과", "에서", "에게", "부터", "까지",
             "입니다", "합니다", "했다", "하다")

    def __init__(self, strip_josa: bool = True):
        super().__init__()
        self.strip_josa = strip_josa

    def _strip(self, word: str) -> str:
        if not self.strip_josa:
            return word
        for j in sorted(self._JOSA, key=len, reverse=True):
            if len(word) > len(j) and word.endswith(j):
                return word[:-len(j)]
        return word

    def create(self, sentence: str) -> Tokenizer:
        tokens = [self._strip(w) for w in re.findall(r"\S+", sentence)]
        return Tokenizer([t for t in tokens if t], self._pre)


# ---------------------------------------------------------------------------
# UIMA-style annotator pipeline (reference: deeplearning4j-nlp-uima —
# UimaTokenizerFactory / UimaSentenceIterator over an AnalysisEngine)
# ---------------------------------------------------------------------------


class Annotation:
    """A typed text span (the CAS annotation analog)."""

    __slots__ = ("type", "begin", "end", "text", "features")

    def __init__(self, type_: str, begin: int, end: int, text: str,
                 **features):
        self.type = type_
        self.begin = begin
        self.end = end
        self.text = text
        self.features = features

    def __repr__(self):
        return f"Annotation({self.type!r}, {self.begin}, {self.end}, " \
               f"{self.text!r})"


class CAS:
    """Common Analysis Structure: the document plus annotations by type."""

    def __init__(self, text: str):
        self.text = text
        self._by_type: dict = {}

    def add(self, ann: Annotation):
        self._by_type.setdefault(ann.type, []).append(ann)

    def select(self, type_: str) -> List[Annotation]:
        return list(self._by_type.get(type_, []))


class AnalysisEngine:
    """An annotator: process(cas) adds annotations."""

    def process(self, cas: CAS) -> None:
        raise NotImplementedError


class SentenceAnnotator(AnalysisEngine):
    _SPLIT = re.compile(r"[^.!?。！？]+[.!?。！？]?")

    def process(self, cas: CAS) -> None:
        for m in self._SPLIT.finditer(cas.text):
            s = m.group().strip()
            if s:
                cas.add(Annotation("sentence", m.start(), m.end(), s))


class TokenAnnotator(AnalysisEngine):
    def __init__(self, factory: Optional[TokenizerFactory] = None):
        from deeplearning4j_tpu_torch.nlp.tokenization import (
            DefaultTokenizerFactory)
        self.factory = factory or DefaultTokenizerFactory()

    def process(self, cas: CAS) -> None:
        sentences = cas.select("sentence") or [
            Annotation("sentence", 0, len(cas.text), cas.text)]
        for sent in sentences:
            pos = sent.begin
            for tok in self.factory.create(sent.text).get_tokens():
                found = cas.text.find(tok, pos)
                b = found if found >= 0 else pos
                cas.add(Annotation("token", b, b + len(tok), tok))
                if found >= 0:
                    pos = found + len(tok)


class AnalysisPipeline:
    """Chains engines over a document (the AnalysisEngine aggregate)."""

    def __init__(self, engines: Sequence[AnalysisEngine]):
        self.engines = list(engines)

    def process(self, text: str) -> CAS:
        cas = CAS(text)
        for e in self.engines:
            e.process(cas)
        return cas


class UimaTokenizerFactory(TokenizerFactory):
    """Tokenizes via an annotator pipeline (reference:
    UimaTokenizerFactory) so custom annotators can rewrite the stream."""

    def __init__(self, pipeline: Optional[AnalysisPipeline] = None):
        super().__init__()
        self.pipeline = pipeline or AnalysisPipeline(
            [SentenceAnnotator(), TokenAnnotator()])

    def create(self, sentence: str) -> Tokenizer:
        cas = self.pipeline.process(sentence)
        return Tokenizer([a.text for a in cas.select("token")],
                         self._pre)


class UimaSentenceIterator:
    """Sentence iterator over documents via the pipeline (reference:
    UimaSentenceIterator)."""

    def __init__(self, documents: Sequence[str],
                 pipeline: Optional[AnalysisPipeline] = None):
        self.documents = list(documents)
        self.pipeline = pipeline or AnalysisPipeline([SentenceAnnotator()])

    def __iter__(self):
        for doc in self.documents:
            for ann in self.pipeline.process(doc).select("sentence"):
                yield ann.text
