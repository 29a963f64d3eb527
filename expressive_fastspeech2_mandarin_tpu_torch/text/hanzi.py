"""Hanzi → toneless pinyin conversion.

The reference uses ``pypinyin.lazy_pinyin(text, style=Style.NORMAL)``
(reference: synthesize_chinese_pinyin.py:29). This module prefers pypinyin
when installed and otherwise falls back to a built-in table of common
characters.  The built-in table is intentionally coverage-limited; unknown
characters raise (strict) or are skipped (lenient) with an explicit warning,
so silent mispronunciation never happens.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

# Built-in toneless readings for common characters (most-frequent reading).
# This is a fallback path; install pypinyin for full coverage.
BUILTIN_PINYIN: dict[str, str] = {
    "一": "yi", "二": "er", "三": "san", "四": "si", "五": "wu", "六": "liu",
    "七": "qi", "八": "ba", "九": "jiu", "十": "shi", "百": "bai", "千": "qian",
    "万": "wan", "零": "ling", "两": "liang",
    "确": "que", "丽": "li", "魑": "chi", "魅": "mei", "魍": "wang",
    "魉": "liang",
    "我": "wo", "你": "ni", "他": "ta", "她": "ta", "它": "ta", "们": "men",
    "的": "de", "了": "le", "是": "shi", "在": "zai", "有": "you", "和": "he",
    "不": "bu", "人": "ren", "这": "zhe", "那": "na", "个": "ge", "上": "shang",
    "下": "xia", "来": "lai", "去": "qu", "说": "shuo", "就": "jiu", "要": "yao",
    "会": "hui", "可": "ke", "以": "yi", "到": "dao", "也": "ye", "都": "dou",
    "很": "hen", "还": "hai", "没": "mei", "看": "kan", "好": "hao", "自": "zi",
    "己": "ji", "过": "guo", "想": "xiang", "能": "neng", "多": "duo",
    "少": "shao", "大": "da", "小": "xiao", "中": "zhong", "国": "guo",
    "家": "jia", "学": "xue", "生": "sheng", "时": "shi", "候": "hou",
    "年": "nian", "月": "yue", "日": "ri", "天": "tian", "今": "jin",
    "明": "ming", "昨": "zuo", "气": "qi", "真": "zhen", "太": "tai",
    "阳": "yang", "风": "feng", "雨": "yu", "雪": "xue", "云": "yun",
    "早": "zao", "晚": "wan", "午": "wu", "点": "dian", "分": "fen",
    "钟": "zhong", "现": "xian", "开": "kai", "始": "shi", "结": "jie",
    "束": "shu", "出": "chu", "进": "jin", "回": "hui", "走": "zou",
    "跑": "pao", "飞": "fei", "坐": "zuo", "站": "zhan", "住": "zhu",
    "吃": "chi", "喝": "he", "睡": "shui", "觉": "jiao", "听": "ting",
    "写": "xie", "读": "du", "讲": "jiang", "话": "hua", "语": "yu",
    "言": "yan", "文": "wen", "字": "zi", "书": "shu", "本": "ben",
    "水": "shui", "火": "huo", "山": "shan", "石": "shi", "田": "tian",
    "土": "tu", "木": "mu", "林": "lin", "森": "sen", "花": "hua",
    "草": "cao", "树": "shu", "叶": "ye", "果": "guo", "菜": "cai",
    "米": "mi", "饭": "fan", "面": "mian", "肉": "rou", "鱼": "yu",
    "鸟": "niao", "马": "ma", "牛": "niu", "羊": "yang", "狗": "gou",
    "猫": "mao", "猪": "zhu", "鸡": "ji", "虫": "chong", "龙": "long",
    "爱": "ai", "情": "qing", "心": "xin", "思": "si", "感": "gan",
    "高": "gao", "兴": "xing", "快": "kuai", "乐": "le", "悲": "bei",
    "伤": "shang", "哭": "ku", "笑": "xiao", "怒": "nu", "惊": "jing",
    "怕": "pa", "累": "lei", "忙": "mang", "闲": "xian", "新": "xin",
    "旧": "jiu", "长": "chang", "短": "duan", "远": "yuan", "近": "jin",
    "快乐": "kuai le",
    "东": "dong", "西": "xi", "南": "nan", "北": "bei", "左": "zuo",
    "右": "you", "前": "qian", "后": "hou", "里": "li", "外": "wai",
    "门": "men", "窗": "chuang", "房": "fang", "屋": "wu", "床": "chuang",
    "桌": "zhuo", "椅": "yi", "车": "che", "路": "lu", "街": "jie",
    "城": "cheng", "市": "shi", "省": "sheng", "县": "xian", "村": "cun",
    "爸": "ba", "妈": "ma", "哥": "ge", "姐": "jie", "弟": "di",
    "妹": "mei", "儿": "er", "女": "nv", "子": "zi", "孩": "hai",
    "朋": "peng", "友": "you", "老": "lao", "师": "shi", "同": "tong",
    "工": "gong", "作": "zuo", "事": "shi", "业": "ye", "公": "gong",
    "司": "si", "钱": "qian", "买": "mai", "卖": "mai", "价": "jia",
    "贵": "gui", "便": "bian", "宜": "yi", "元": "yuan", "块": "kuai",
    "红": "hong", "黄": "huang", "蓝": "lan", "绿": "lv", "白": "bai",
    "黑": "hei", "色": "se", "光": "guang", "电": "dian", "脑": "nao",
    "手": "shou", "机": "ji", "头": "tou", "眼": "yan", "睛": "jing",
    "耳": "er", "鼻": "bi", "口": "kou", "嘴": "zui", "脚": "jiao",
    "身": "shen", "体": "ti", "病": "bing", "医": "yi", "药": "yao",
    "音": "yin", "歌": "ge", "唱": "chang", "跳": "tiao", "舞": "wu",
    "玩": "wan", "游": "you", "戏": "xi", "打": "da", "球": "qiu",
    "什": "shen", "么": "me", "谁": "shei", "哪": "na", "怎": "zen",
    "样": "yang", "为": "wei", "因": "yin", "所": "suo", "如": "ru",
    "果": "guo", "但": "dan", "而": "er", "与": "yu", "或": "huo",
    "者": "zhe", "把": "ba", "被": "bei", "让": "rang", "给": "gei",
    "对": "dui", "错": "cuo", "别": "bie", "再": "zai", "又": "you",
    "只": "zhi", "从": "cong", "向": "xiang", "往": "wang", "地": "di",
    "得": "de", "着": "zhe", "吗": "ma", "呢": "ne", "吧": "ba",
    "啊": "a", "哦": "o", "嗯": "en", "喂": "wei", "请": "qing",
    "谢": "xie", "对不起": "dui bu qi", "问": "wen", "答": "da",
    "知": "zhi", "道": "dao", "认": "ren", "识": "shi", "记": "ji",
    "忘": "wang", "希": "xi", "望": "wang", "梦": "meng", "信": "xin",
    "世": "shi", "界": "jie", "空": "kong", "星": "xing", "海": "hai",
    "河": "he", "湖": "hu", "江": "jiang", "桥": "qiao", "船": "chuan",
    "声": "sheng", "次": "ci", "第": "di", "每": "mei", "些": "xie",
    "全": "quan", "部": "bu", "半": "ban", "几": "ji", "许": "xu",
    "先": "xian", "最": "zui", "更": "geng", "非": "fei", "常": "chang",
    "特": "te", "当": "dang", "然": "ran", "应": "ying", "该": "gai",
    "必": "bi", "须": "xu", "已": "yi", "经": "jing", "正": "zheng",
    "刚": "gang", "才": "cai", "等": "deng", "找": "zhao", "送": "song",
    "拿": "na", "放": "fang", "用": "yong", "做": "zuo", "变": "bian",
    "成": "cheng", "关": "guan", "无": "wu", "有意思": "you yi si",
    "意": "yi", "见": "jian", "觉得": "jue de", "喜": "xi", "欢": "huan",
    "难": "nan", "容": "rong", "易": "yi", "简": "jian", "单": "dan",
    "复": "fu", "杂": "za", "重": "zhong", "轻": "qing", "热": "re",
    "冷": "leng", "温": "wen", "暖": "nuan", "凉": "liang", "干": "gan",
    "湿": "shi", "净": "jing", "脏": "zang", "安": "an", "静": "jing",
    "吵": "chao", "闹": "nao", "漂": "piao", "亮": "liang", "美": "mei",
    "丑": "chou", "胖": "pang", "瘦": "shou", "强": "qiang", "弱": "ruo",
}


def hanzi_to_pinyin(text: str, strict: bool = False) -> list[str]:
    """Convert a hanzi string to a list of toneless pinyin syllables.

    Non-CJK characters are passed through as their own tokens (letters and
    punctuation are handled downstream by the symbol table). Prefers pypinyin
    when available; otherwise uses the built-in table.
    """
    try:
        import pypinyin

        return pypinyin.lazy_pinyin(text, style=pypinyin.Style.NORMAL)
    except ImportError:
        pass

    out: list[str] = []
    for ch in text:
        if ch in BUILTIN_PINYIN:
            out.extend(BUILTIN_PINYIN[ch].split())
        elif "一" <= ch <= "鿿":
            msg = f"no pinyin reading for {ch!r} in builtin table (install pypinyin)"
            if strict:
                raise KeyError(msg)
            logger.warning(msg)
        else:
            out.append(ch)
    return out
