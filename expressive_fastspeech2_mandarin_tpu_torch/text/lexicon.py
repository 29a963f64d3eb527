"""Pinyin lexicon files: the standard syllable inventory decomposed into
phones by ``text/pinyin.py``'s rules, written in the MFA dictionary format
(``syllable<TAB>phones``) that the aligner (``align.align_corpus(...,
lexicon=...)``) and external aligners read; the JAX package's
``text/lexicon.py``.
"""

from __future__ import annotations

from .pinyin import pinyin_to_phonemes

# The standard Mandarin syllable inventory (toneless), grouped by initial.
_SYLLABLES = """
a o e ai ei ao ou an en ang eng er
ba bo bai bei bao ban ben bang beng bi bie biao bian bin bing bu
pa po pai pei pao pou pan pen pang peng pi pie piao pian pin ping pu
ma mo me mai mei mao mou man men mang meng mi mie miao miu mian min ming mu
fa fo fei fou fan fen fang feng fu
da de dai dei dao dou dan den dang deng di die diao diu dian ding dong du duan dun duo dui
ta te tai tao tou tan tang teng ti tie tiao tian ting tong tu tuan tun tuo tui
na ne nai nei nao nou nan nen nang neng ni nie niao niu nian nin niang ning nong nu nuan nuo nv nve
la le lai lei lao lou lan lang leng li lia lie liao liu lian lin liang ling long lu luan lun luo lv lve
ga ge gai gei gao gou gan gen gang geng gu gua guai guan guang gui gun guo
ka ke kai kei kao kou kan ken kang keng ku kua kuai kuan kuang kui kun kuo
ha he hai hei hao hou han hen hang heng hu hua huai huan huang hui hun huo
ji jia jie jiao jiu jian jin jiang jing jiong ju juan jun jue
qi qia qie qiao qiu qian qin qiang qing qiong qu quan qun que
xi xia xie xiao xiu xian xin xiang xing xiong xu xuan xun xue
zha zhe zhi zhai zhei zhao zhou zhan zhen zhang zheng zhu zhua zhuai zhuan zhuang zhui zhun zhuo zhong
cha che chi chai chao chou chan chen chang cheng chu chua chuai chuan chuang chui chun chuo chong
sha she shi shai shei shao shou shan shen shang sheng shu shua shuai shuan shuang shui shun shuo
re ri rao rou ran ren rang reng ru rua ruan rui run ruo rong
za ze zi zai zei zao zou zan zen zang zeng zu zuan zun zuo zui zong
ca ce ci cai cao cou can cen cang ceng cu cuan cun cuo cui cong
sa se si sai sao sou san sen sang seng su suan sun suo sui song
ya yo ye yao you yan yin yang ying yong yu yuan yun yue
wa wo wai wei wan wen wang weng wu
""".split()


def standard_syllables() -> list[str]:
    return list(_SYLLABLES)


def build_lexicon(syllables: list[str] | None = None,
                  with_tones: bool = False) -> dict[str, list[str]]:
    """{syllable: phonemes} via the rule-based decomposition. With
    ``with_tones``, adds toned variants (1-5) mapping to the same toneless
    phones (matching the reference dict's toneless phone set)."""
    syllables = syllables or standard_syllables()
    lex: dict[str, list[str]] = {}
    for syl in syllables:
        phones = pinyin_to_phonemes(syl)
        if not phones:
            continue
        lex[syl] = phones
        if with_tones:
            for tone in "12345":
                lex[syl + tone] = phones
    return lex


def write_lexicon(path: str, lexicon: dict[str, list[str]] | None = None,
                  with_tones: bool = False) -> int:
    lexicon = lexicon or build_lexicon(with_tones=with_tones)
    with open(path, "w", encoding="utf-8") as f:
        for word in sorted(lexicon):
            f.write(f"{word}\t{' '.join(lexicon[word])}\n")
    return len(lexicon)
