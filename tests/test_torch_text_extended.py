"""The port's text front ends against the JAX package's, on every input of
tests/test_normalizer.py and tests/test_text_extended.py and more: the
Chinese normalizer, the five cleaners, English numbers and G2P, the Korean
jamo front end and pronunciation rules, ``text_to_sequence`` and the pinyin
lexicon writer. Outputs must be equal; lexicon files equal byte for byte.

The optional packages (``unidecode``, ``g2p_en``, ``g2pk``) are made
unimportable for every test here, so both packages take the fallbacks the
card takes (it has none of them)."""

import sys

import pytest

from expressive_fastspeech2_mandarin_tpu import text as jtext
from expressive_fastspeech2_mandarin_tpu.text import cleaners as jcleaners
from expressive_fastspeech2_mandarin_tpu.text import english as jenglish
from expressive_fastspeech2_mandarin_tpu.text import korean as jkorean
from expressive_fastspeech2_mandarin_tpu.text import lexicon as jlexicon
from expressive_fastspeech2_mandarin_tpu.text import normalizer_zh as jnorm
from expressive_fastspeech2_mandarin_tpu.text import numbers_en as jnumbers
from expressive_fastspeech2_mandarin_tpu_torch import text as ttext
from expressive_fastspeech2_mandarin_tpu_torch.text import cleaners as tcleaners
from expressive_fastspeech2_mandarin_tpu_torch.text import english as tenglish
from expressive_fastspeech2_mandarin_tpu_torch.text import korean as tkorean
from expressive_fastspeech2_mandarin_tpu_torch.text import lexicon as tlexicon
from expressive_fastspeech2_mandarin_tpu_torch.text import normalizer_zh as tnorm
from expressive_fastspeech2_mandarin_tpu_torch.text import numbers_en as tnumbers

OPTIONAL = ("unidecode", "g2p_en", "g2pk")


@pytest.fixture(autouse=True)
def no_optional_packages(monkeypatch):
    for name in OPTIONAL:
        monkeypatch.setitem(sys.modules, name, None)


# tests/test_normalizer.py's inputs.
NUMBERS = ["0", "5", "10", "12", "20", "105", "110", "1000", "10001",
           "12345", "100000000", "203040"]
DIGITS = ["110", "13912345678"]
SENTENCES = [
    "今天是2024年3月5日", "现在是14:30", "价格是¥12.5", "增长了20%",
    "大约3/4的人", "气温-5℃", "我有3个苹果", "电话是010-12345678",
    "手机13812345678", "大概5~10天", "圆周率是3.14", "我有3个",
    "我的车牌是粤AD74821。", "粤A D74821", "粤AD74821", "路程是10.23公里",
    "一共是10个人", "他重70千克", "我今年83岁半了", "比分是3:2",
    "现在是12:30", "你好,世界!", "嗯…好", "水温90°", "派是π", "A&B",
    # More: money in dollars, decimals, ranges, acronyms, symbols.
    "他花了$1,234.56买了GPU", "会议在2023/12/01的9:05:30开始",
    "温度是-3.5°C到2℃", "1+1=2", "第100000001名", "3.0-4.5公斤",
    "面积是20㎡", "长度5km，重量3kg", "我的邮箱是a@b.com", "比例1:10",
    "价格是￥ 3,000", "投票率66.7 %", "0.5", "-12", "NASA和CCTV",
]
# tests/test_text_extended.py's inputs.
KOREAN_NUMBERS = [0, 1, 10, 11, 25, 100, 345, 10000, 12345,
                  100000000, 20000, 110000001, -7]
KOREAN_TEXTS = ["한국", "가", "안녕하세요 3번", "같이", "좋다", "입니다", "설날",
                "한국말", "학교", "옷이", "읽다", "않아", "밥물", "독립",
                "넓다", "국밥", "놓는", "abc 123!", "같이 가요.",
                "오늘은 2024년 3월 15일입니다", "값이 12000원이에요",
                "  여러   칸의  공백  "]
ENGLISH_TEXTS = [
    "  Hello  World ", "Dr. Smith paid $3.50 for 2 apples.",
    "Mrs. Jones, St. Mary's Co. Ltd.", "It's 1,000,000 dollars!",
    "The 21st and 3rd of May, 1999.", "Café naïve résumé — déjà vu",
    "£100 and $0.99 and $1 and $2.", "Capt. Gen. Maj. Lt. Sgt. Col. Ft.",
    "3.14159 is pi; 12th, 101st, 1000000000000.", "Ünïcödé ΑΒΓ 中文 text",
]
CLEANERS = ["basic_cleaners", "transliteration_cleaners", "english_cleaners",
            "chinese_cleaners", "korean_cleaners"]


@pytest.mark.parametrize("n", NUMBERS)
def test_verbalize_number_matches_jax(n):
    assert tnorm.verbalize_number(n) == jnorm.verbalize_number(n)
    assert tnorm.verbalize_decimal(n + ".25") == jnorm.verbalize_decimal(
        n + ".25")


@pytest.mark.parametrize("s", DIGITS)
def test_verbalize_digits_matches_jax(s):
    assert tnorm.verbalize_digits(s) == jnorm.verbalize_digits(s)


@pytest.mark.parametrize("text", SENTENCES)
def test_normalize_chinese_matches_jax(text):
    ours = tnorm.normalize_chinese(text)
    assert ours == jnorm.normalize_chinese(text)
    assert ttext.chinese_text_to_ids(ours) == jtext.chinese_text_to_ids(ours)


@pytest.mark.parametrize("name", CLEANERS)
@pytest.mark.parametrize("text", ENGLISH_TEXTS + SENTENCES[:4]
                         + KOREAN_TEXTS[:3])
def test_cleaners_match_jax(name, text):
    assert tcleaners.clean_text(text, [name]) == jcleaners.clean_text(
        text, [name])


@pytest.mark.parametrize("name", ["chinese_cleaners", "english_cleaners"])
def test_named_cleaners_are_registered(name):
    """A preprocess.yaml naming these cleaners raised "Unknown cleaner" in
    the port while the JAX package ran it."""
    ours = ttext.clean_text("  Hello  World ", [name])
    assert ours == jtext.clean_text("  Hello  World ", [name])
    assert ours == {"chinese_cleaners": " Hello World ",
                    "english_cleaners": " hello world "}[name]


def test_cleaner_chain_and_unknown_name():
    names = ["english_cleaners", "basic_cleaners", "chinese_cleaners"]
    text = "Dr.  Who's  $5 "
    assert tcleaners.clean_text(text, names) == jcleaners.clean_text(
        text, names)
    with pytest.raises(ValueError, match="Unknown cleaner: nope"):
        tcleaners.clean_text(text, ["nope"])


def test_optional_packages_take_the_fallbacks():
    """With unidecode, g2p_en and g2pk unimportable, both packages
    transliterate by NFKD, spell OOV English by characters and apply the
    native Korean rules, alike."""
    for name in OPTIONAL:
        with pytest.raises(ImportError):
            __import__(name)
    assert tcleaners.convert_to_ascii("Café déjà 中") == "Cafe deja "
    assert jcleaners.convert_to_ascii("Café déjà 中") == "Cafe deja "
    assert tenglish.english_to_phonemes("zq") == ["z", "q"]
    assert jenglish.english_to_phonemes("zq") == ["z", "q"]
    assert tkorean.normalize("같이") == jkorean.normalize("같이") == "가치"


@pytest.mark.parametrize("text", ENGLISH_TEXTS)
def test_normalize_numbers_matches_jax(text):
    assert tnumbers.normalize_numbers(text) == jnumbers.normalize_numbers(
        text)


@pytest.mark.parametrize("n", [0, 1, 13, 20, 99, 100, 101, 999, 1000, 1001,
                               21000, 1000000, 123456789, -42])
def test_number_and_ordinal_words_match_jax(n):
    assert tnumbers.number_to_words(n) == jnumbers.number_to_words(n)
    if n > 0:
        assert tnumbers.ordinal_to_words(n) == jnumbers.ordinal_to_words(n)


def _cmudict(tmp_path):
    path = tmp_path / "cmu.dict"
    path.write_text(
        ";;; comment\n# another comment\nHELLO  HH AH0 L OW1\n"
        "HELLO(1)  HH EH0 L OW1\nWORLD  W ER1 L D\nIT'S  IH1 T S\n"
        "BROKEN LINE WITHOUT TWO SPACES\nPAID  P EY1 D\n", encoding="latin-1")
    return str(path)


@pytest.mark.parametrize("text", ["hello world zzz", "Hello, World! It's",
                                  "paid 3 dollars.", "", "HELLO hello"])
def test_english_to_phonemes_matches_jax(text, tmp_path):
    path = _cmudict(tmp_path)
    ours, ref = tenglish.CMUDict(path), jenglish.CMUDict(path)
    assert len(ours) == len(ref) == 4
    assert ours.lookup("hello") == ref.lookup("hello") == [
        "HH", "AH0", "L", "OW1"]
    assert (tenglish.english_to_phonemes(text, ours)
            == jenglish.english_to_phonemes(text, ref))
    assert (tenglish.english_to_phonemes(text)
            == jenglish.english_to_phonemes(text))
    unambiguous = tenglish.CMUDict(path, keep_ambiguous=False)
    assert unambiguous.lookup("HELLO") == ["HH", "AH0", "L", "OW1"]


@pytest.mark.parametrize("text", KOREAN_TEXTS)
def test_korean_matches_jax(text):
    assert tkorean.hangul_to_jamo(text) == jkorean.hangul_to_jamo(text)
    assert tkorean.pronounce(text) == jkorean.pronounce(text)
    assert tkorean.normalize(text) == jkorean.normalize(text)
    assert tkorean.korean_text_to_ids(text) == jkorean.korean_text_to_ids(
        text)


@pytest.mark.parametrize("n", KOREAN_NUMBERS)
def test_number_to_korean_matches_jax(n):
    assert tkorean.number_to_korean(n) == jkorean.number_to_korean(n)


def test_korean_symbol_table_matches_jax():
    assert tkorean.KOREAN_SYMBOLS == jkorean.KOREAN_SYMBOLS
    assert tkorean.char_to_id == jkorean.char_to_id


@pytest.mark.parametrize("text", [
    "Hello {a˥˩ m} World!", "{n i}", "Dr. Smith paid $3.50",
    "pre {ʂ ʐ̩˥˩ unknown} mid {t} post", "no braces at all", "{}", "",
    "a{b", "{@spn} 42"])
@pytest.mark.parametrize("cleaners", [["english_cleaners"],
                                      ["basic_cleaners"], []])
def test_text_to_sequence_matches_jax(text, cleaners):
    assert (ttext.text_to_sequence(text, cleaners)
            == jtext.text_to_sequence(text, cleaners))


def test_standard_syllables_and_build_lexicon_match_jax():
    assert tlexicon.standard_syllables() == jlexicon.standard_syllables()
    for tones in (False, True):
        ours = tlexicon.build_lexicon(with_tones=tones)
        assert ours == jlexicon.build_lexicon(with_tones=tones)
        assert len(ours) == len(tlexicon.standard_syllables()) * (
            6 if tones else 1)
    few = ["ba", "zhuang", "xx", "lve"]
    assert tlexicon.build_lexicon(few) == jlexicon.build_lexicon(few)


@pytest.mark.parametrize("tones", [False, True])
def test_write_lexicon_matches_jax_byte_for_byte(tones, tmp_path):
    ours, ref = tmp_path / "ours.dict", tmp_path / "ref.dict"
    n = tlexicon.write_lexicon(str(ours), with_tones=tones)
    assert n == jlexicon.write_lexicon(str(ref), with_tones=tones)
    assert ours.read_bytes() == ref.read_bytes()
    first = ours.read_text(encoding="utf-8").splitlines()[0]
    assert first.split("\t") == ["a", "a"]
    custom = {"ni3": ["n", "i"], "hao3": ["h", "ao"]}
    tlexicon.write_lexicon(str(ours), custom)
    jlexicon.write_lexicon(str(ref), custom)
    assert ours.read_bytes() == ref.read_bytes() == (
        "hao3\th ao\nni3\tn i\n".encode())
