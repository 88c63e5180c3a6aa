# -*- coding: utf-8 -*-
r"""Text frontend: normalization, BPE tokenization, sentence splitting.

Public surface mirrors the reference frontend (indextts/utils/front.py):
`TextNormalizer` (zh/en routing, pinyin-tone protection, Chinese-name
protection, English contractions, punctuation replacement maps) and
`TextTokenizer` (SentencePiece BPE with CJK-char pre-tokenization, sentence
split/merge with punctuation / comma / dash fallbacks and hard chunking).

The reference's WeTextProcessing pynini FSTs (front.py:100-111) are replaced by
the rule-based verbalizer in zh_num.py plus the regex passes below — same
routing and protection semantics, self-contained implementation.

WeTextProcessing (tn.chinese/english) category checklist — every row has a
pinned test (tests/test_frontend.py: corpus = TestNormalizerReferenceCorpus,
cat = TestNormalizerWextCategories):

  category                 | rule (this file)            | test
  -------------------------+-----------------------------+--------------------
  full dates 2025/1/2      | _normalize_zh dates         | corpus (iPhone ¥)
  years 2002年             | years rule                  | corpus (第一场雪)
  partial dates 3月5号     | partial-date rule           | cat (month-day)
  weekdays 周3/星期7       | weekday rule                | cat (weekday)
  clock times 20:00        | _time                       | corpus (北京时间)
  phone/long IDs           | phone + \d{8,} digit read   | corpus (电话) / cat (卡号)
  temperatures ±°C/°F      | temperature rules           | cat (气温/体温)
  percents 2.5%            | percent rule                | corpus (IndexTTS)
  ordinals 第N             | 第 rule (二 never 两)       | cat (第1名/第2000名)
  money ¥/$                | money rules                 | corpus (¥12999)
  currency ranges ¥X-Y     | currency-range rules        | cat (价格区间)
  plain ranges 3-5/3~5     | range rule                  | cat (预计3-5天)
  fractions 1/3            | fraction rule               | cat (篇幅/比分)
  negatives -5             | negative rule               | cat (海拔)
  trailing plus 3000+      | plus rule                   | corpus (点赞)
  units km/h, 3.2g         | unit rules                  | corpus (速度) / cat (重3.2g)
  scale-word 两 (2万)      | 两-before-scale rule        | cat (2万元)
  measure-word 两 (2个)    | 两-before-counter rule      | cat (measure words)
  mixed 万/亿 + decimals   | generic zh_number + 万亿    | cat (3.5万亿)
  general numbers          | final zh_number pass        | corpus (465篇/315万字)
  scores/ratios 3:2        | leftover-colon 比 rule      | cat (比分)
  time ranges 8:00-22:00   | dash->到 pre-rewrite        | cat (营业时间)
  date ranges 5日-7日 etc  | date-range continuation     | cat (会议/旺季)
  versions/IPs 16.4.1      | dotted-sequence rule        | cat (iOS/IP)
  temp ranges -5~3℃       | temperature-range rule      | cat (温度在)
  year+month ranges        | same-separator date form    | review-regr (2025年1-3月)
  ordinal ranges 第3-5     | 第-range rule               | review-regr (第3-5名)
  huge ints >= 10^16       | digit-by-digit fallback     | review-regr (第10^16名)
  math ×÷+=±               | operator pass               | cat (5×3, 1+1=2)
  thousands seps 100,000   | comma strip                 | cat (人参加)
  unit glyphs ㎡/km²/㎏    | glyph replace               | cat (面积/占地)
  signed percent -2.3%     | percent sign capture        | cat (股价)
  letter IDs 京A12345      | letter-attached digit rule  | cat (车牌)
  en times/money/percent/  | _normalize_en               | corpus + cat (en)
    ordinals/cents/ranges/ |                             |
    versions/math/seps     |                             |
  en dates/decades/phones/ | _normalize_en (round 5)     | TestEnAdversarialCorpusR5
    fractions/measures/abbr|                             |
  en electronic (email/URL)| _email/_url rules           | R5 (electronic)
  en a.m.-p.m./streets/    | abbr + AM/PM + feet rules   | R5 (a.m. / St. / 6'2")
    feet-inches/#N/4x4/18+ |                             |
"""

from __future__ import annotations

import os
import re
import warnings
from typing import List, Optional, Tuple, Union

from indextts_tpu_torch.utils.common import de_tokenized_by_CJK_char, tokenize_by_CJK_char
from indextts_tpu_torch.utils.spm import SentencePieceProcessor
from indextts_tpu_torch.utils import zh_num


# ---------------------------------------------------------------------------
# span protection: hide substrings behind sentinels while verbalizers run
# ---------------------------------------------------------------------------


def _slot_name(index: int) -> str:
    return chr(ord("a") + index)


def _stash_spans(text: str, pattern: re.Pattern, sentinel) -> Tuple[str, Optional[List[str]]]:
    """Swap every match of `pattern` for a numbered sentinel so the digit /
    latin verbalizer passes cannot touch it. Returns the masked text and the
    ordered unique match list (None when nothing matched — the contract the
    restore side checks)."""
    found = [m.group(0) for m in pattern.finditer(text)]
    if not found:
        return text, None
    unique = list(dict.fromkeys(found))
    for slot, span in enumerate(unique):
        text = text.replace(span, sentinel(slot))
    return text, unique


def _restore_spans(text: str, spans: Optional[List[str]], sentinel, transform=None) -> str:
    if not spans:
        return text
    for slot, span in enumerate(spans):
        text = text.replace(sentinel(slot), transform(span) if transform else span)
    return text


def _pinyin_sentinel(slot: int) -> str:
    return f"<pinyin_{_slot_name(slot)}>"


def _name_sentinel(slot: int) -> str:
    return f"<n_{_slot_name(slot)}>"


class TextNormalizer:
    """zh/en text normalizer (behavioral reference: front.py:11-228)."""

    def __init__(self):
        self.loaded = False
        self.char_rep_map = {
            "：": ",",
            "；": ",",
            ";": ",",
            "，": ",",
            "。": ".",
            "！": "!",
            "？": "?",
            "\n": " ",
            "·": "-",
            "、": ",",
            "...": "…",
            ",,,": "…",
            "，，，": "…",
            "……": "…",
            "“": "'",
            "”": "'",
            '"': "'",
            "‘": "'",
            "’": "'",
            "（": "'",
            "）": "'",
            "(": "'",
            ")": "'",
            "《": "'",
            "》": "'",
            "【": "'",
            "】": "'",
            "[": "'",
            "]": "'",
            "—": "-",
            "～": "-",
            "~": "-",
            "「": "'",
            "」": "'",
            ":": ",",
        }
        self.zh_char_rep_map = {"$": ".", **self.char_rep_map}
        self._en_rep_re = self._compile_rep(self.char_rep_map)
        self._zh_rep_re = self._compile_rep(self.zh_char_rep_map)

    @staticmethod
    def _compile_rep(rep_map) -> re.Pattern:
        return re.compile("|".join(re.escape(k) for k in rep_map))

    # pinyin-with-tone pattern (reference: front.py:62). Intentional delta:
    # the trailing (?![0-9]) guard is added — a tone digit is never followed
    # by more digits, while the reference's unguarded pattern captures the
    # "A1" of "京A12345" as pinyin and mangles the digit string.
    PINYIN_TONE_PATTERN = (
        r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
        r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|"
        r"[aeiuv]n|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])(?![0-9])"
    )
    # Chinese full names joined by ·/-/— (reference: front.py:68)
    NAME_PATTERN = r"[一-鿿]+(?:[-·—][一-鿿]+){1,2}"
    # common English contractions expanded to "is" (reference: front.py:75)
    ENGLISH_CONTRACTION_PATTERN = r"(what|where|who|which|how|t?here|it|s?he|that|this)'s"

    _EMAIL_RE = re.compile(r"[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$")
    _HANZI_RE = re.compile(r"[一-鿿]")
    _ALPHA_RE = re.compile(r"[a-zA-Z]")

    def load(self):
        self.loaded = True

    # -- routing -----------------------------------------------------------
    def match_email(self, email: str) -> bool:
        return self._EMAIL_RE.match(email) is not None

    def use_chinese(self, s: str) -> bool:
        """Route to the zh pipeline when the text contains hanzi, contains no
        latin letters at all, looks like an email, or carries pinyin tone
        digits (the reference's routing, front.py:115-131)."""
        if self._HANZI_RE.search(s):
            return True
        if not self._ALPHA_RE.search(s):
            return True
        if self.match_email(s):
            return True
        return re.search(self.PINYIN_TONE_PATTERN, s, re.IGNORECASE) is not None

    # -- pinyin / name protection -------------------------------------------
    def correct_pinyin(self, pinyin: str) -> str:
        """jqx + u/ü finals read as v (reference: front.py:144-155)."""
        if pinyin[:1].lower() != "j" and pinyin[:1].lower() != "q" and pinyin[:1].lower() != "x":
            return pinyin
        fixed = re.sub(
            r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>", pinyin, flags=re.IGNORECASE
        )
        return fixed.upper()

    def save_pinyin_tones(self, original_text: str):
        return _stash_spans(
            original_text, re.compile(self.PINYIN_TONE_PATTERN, re.IGNORECASE), _pinyin_sentinel
        )

    def restore_pinyin_tones(self, normalized_text: str, original_pinyin_list):
        return _restore_spans(
            normalized_text, original_pinyin_list, _pinyin_sentinel, self.correct_pinyin
        )

    def save_names(self, original_text: str):
        return _stash_spans(original_text, re.compile(self.NAME_PATTERN), _name_sentinel)

    def restore_names(self, normalized_text: str, original_name_list):
        return _restore_spans(normalized_text, original_name_list, _name_sentinel)

    # -- verbalization passes ----------------------------------------------
    def _normalize_zh(self, text: str) -> str:
        """Chinese ITN: numbers/dates/times/money/percent -> hanzi readings."""
        t = text
        # thousands separators: 100,000 -> 100000 (else the comma splits the
        # number and the final pass reads "一百,零"). Whole-number match only
        # — the left group must be 1-3 digits ("2023,456" is an enumeration,
        # not grouping)
        t = re.sub(
            r"(?<![\d.])\d{1,3}(?:,\d{3})+(?![\d,])",
            lambda m: m.group(0).replace(",", ""),
            t,
        )
        # squared/compound unit glyphs -> verbalizable unit words
        for glyph, word in (
            ("km²", "平方千米"), ("cm²", "平方厘米"), ("m²", "平方米"),
            ("㎡", "平方米"), ("㎞", "千米"), ("㎝", "厘米"), ("㎜", "毫米"),
            ("㎏", "千克"), ("㎎", "毫克"),
        ):
            t = t.replace(glyph, word)
        # math operators between digits (while both sides are still digits):
        # 5×3 -> 5乘3, 1+1=2 -> 1加1等于2, ±3 -> 正负3
        t = re.sub(r"(?<=\d)\s*×\s*(?=\d)", "乘", t)
        t = re.sub(r"(?<=\d)\s*÷\s*(?=\d)", "除以", t)
        t = re.sub(r"(?<=\d)\s*\+\s*(?=\d)", "加", t)
        t = re.sub(r"(?<=\d)\s*=\s*(?=[-\d])", "等于", t)
        t = re.sub(r"±(?=\d)", "正负", t)
        # same-measure-word ranges: 2倍-3倍 -> 2倍到3倍 (the dash sits after
        # the measure char, so the generic digit-range rule never sees it and
        # the negative rule would read 负三倍). 年 covers both duration
        # (5年-7年) and year ranges (2021年-2023年, before the year rule
        # converts the digits)
        t = re.sub(
            r"(?<=\d)(倍|次|个|天|年|层|只|条|人|岁|届|站|元|米|克|页|章|集|期|轮|局)"
            r"\s*[-~～]\s*(?=\d+(?:\.\d+)?\1)",
            r"\1到",
            t,
        )
        # dates: 2025年01月11日 / 2025/1/2 / 2025-01-11 (only full dates).
        # The 年-form requires a literal 月 and the separator form requires
        # the SAME separator twice: a mixed class would swallow year+month
        # ranges ("2025年1-3月") as bogus full dates with a spurious 日
        def _full_date(y, mth, d):
            return (zh_num.zh_digits(y) + "年" + zh_num.zh_integer(mth)
                    + "月" + zh_num.zh_integer(d) + "日")

        t = re.sub(
            r"(\d{2,4})\s*年\s*(\d{1,2})\s*月\s*(\d{1,2})\s*[日号]",
            lambda m: _full_date(m.group(1), m.group(2), m.group(3)),
            t,
        )
        # marker-less day (2025年1月2): only when the digits STOP there and
        # form a real day — otherwise 年N月 followed by a count (2025年3月
        # 1000米) would eat the count's first digits as a bogus 日
        t = re.sub(
            r"(\d{2,4})\s*年\s*(\d{1,2})\s*月\s*(\d{1,2})(?!\d)",
            lambda m: (_full_date(m.group(1), m.group(2), m.group(3))
                       if 1 <= int(m.group(3)) <= 31 else m.group(0)),
            t,
        )
        t = re.sub(
            r"(\d{2,4})\s*([/-])\s*(\d{1,2})\s*\2\s*(\d{1,2})(?![\d月])",
            lambda m: _full_date(m.group(1), m.group(3), m.group(4)),
            t,
        )
        # years: 2002年
        t = re.sub(r"(\d{3,4})年", lambda m: zh_num.zh_digits(m.group(1)) + "年", t)
        # partial dates: 3月5号 / 03月15日 (year-less; the full-date rule
        # above already consumed 年月日 triples)
        t = re.sub(
            r"(\d{1,2})\s*月\s*(\d{1,2})\s*([日号])",
            lambda m: zh_num.zh_integer(m.group(1)) + "月" + zh_num.zh_integer(m.group(2)) + m.group(3),
            t,
        )
        # date-range continuations: 3月5日-7日 -> …日到七日 (the negative rule
        # would otherwise read the dash as a minus sign: 负七日)
        t = re.sub(
            r"(?<=[日号])\s*[-~～]\s*(\d{1,2})\s*([日号])",
            lambda m: "到" + zh_num.zh_integer(m.group(1)) + m.group(2),
            t,
        )
        t = re.sub(
            r"(?<=月)\s*[-~～]\s*(\d{1,2})\s*月",
            lambda m: "到" + zh_num.zh_integer(m.group(1)) + "月",
            t,
        )
        # weekdays: 周3 / 星期2 / 礼拜7 / 上周5. NOT converted when the digit
        # reads as a count: another digit/dot follows (周1000米), or a
        # measure word follows (一周7天, 每周3次) — there 周 is the noun
        # "week" and the digit keeps its numeric reading
        _wd = {"1": "一", "2": "二", "3": "三", "4": "四", "5": "五", "6": "六", "7": "日"}
        t = re.sub(
            r"(?<![0-9])(星期|周|礼拜)([1-7])(?![\d.次天个人回遍趟站年月号里米克磅吨寸尺码条件只张])",
            lambda m: m.group(1) + _wd[m.group(2)],
            t,
        )
        # clock times: 20:00 / 8:30 / 08:00:30
        def _time(m):
            h, mm, ss = m.group(1), m.group(2), m.group(3)
            out = zh_num.zh_integer(h) + "点"
            if mm and int(mm) > 0:
                # zero-padded minutes keep the 零: 1:02 -> 一点零二分
                out += ("零" if mm.startswith("0") else "") + zh_num.zh_integer(mm) + "分"
            elif mm and ss and int(ss) > 0:
                # 08:00:30 keeps the zero minutes (八点零分三十秒) — dropping
                # them reads adjacent to 八点三十 (8:30)
                out += "零分"
            if ss and int(ss) > 0:
                out += ("零" if ss.startswith("0") else "") + zh_num.zh_integer(ss) + "秒"
            return out

        # time ranges: 8:00-22:00 -> 八点到二十二点 (rewrite the dash before
        # the single-time rule consumes the endpoints)
        t = re.sub(r"(?<=\d)\s*[-~～]\s*(?=\d{1,2}:\d{2})", "到", t)
        # digit guards: "120:119" is a score, not the time "20:11" embedded
        # in it — whole numbers only on both sides of the colon
        t = re.sub(r"(?<!\d)(\d{1,2}):(\d{2})(?::(\d{2}))?(?!\d)", _time, t)
        # leftover digit colons are ratios/scores, not times (3:2 -> 三比二,
        # 120:119 -> 一百二十比一百一十九; valid clock times were consumed above)
        t = re.sub(
            r"(\d+):(\d+)",
            lambda m: zh_num.zh_integer(m.group(1)) + "比" + zh_num.zh_integer(m.group(2)),
            t,
        )
        # phone numbers: 135-4567-8900 -> digit-by-digit with 幺
        t = re.sub(
            r"\d{3,4}-\d{3,4}-\d{3,4}",
            lambda m: zh_num.zh_digits(m.group(0).replace("-", ""), tel=True),
            t,
        )
        # landlines with area code: 010-12345678 -> 零幺零幺二三四五六七八
        # (the generic range rule would read the dash as 到)
        t = re.sub(
            r"(?<!\d)0\d{2,3}-\d{7,8}(?!\d)",
            lambda m: zh_num.zh_digits(m.group(0).replace("-", ""), tel=True),
            t,
        )
        # mobile numbers, optionally +86-prefixed and space/dash-grouped:
        # +86 138 0013 8000 -> 加八六幺三八零零幺三八零零零
        t = re.sub(
            r"(?<![\d])(\+86[\s-]*)?(1[3-9]\d)[\s-]?(\d{4})[\s-]?(\d{4})(?!\d)",
            lambda m: (("加八六" if m.group(1) else "")
                       + zh_num.zh_digits(m.group(2) + m.group(3) + m.group(4),
                                          tel=True)),
            t,
        )
        # leading plus as a sign: +15 -> 正十五 (digit+digit addition was
        # consumed by the operator pass above; phone prefixes just above)
        t = re.sub(r"(?<![\d])\+(?=\d)", "正", t)
        # dotted sequences (versions / IPs): 16.4.1 -> 十六点四点一,
        # 192.168.1.1 -> 一九二点一六八点一点一 (short clean groups read as
        # integers, long or zero-padded ones digit-by-digit)
        def _dotted(m):
            parts = m.group(0).split(".")
            if all(len(p) <= 2 and not p.startswith("0") for p in parts):
                return "点".join(zh_num.zh_integer(p) for p in parts)
            return "点".join(zh_num.zh_digits(p) for p in parts)

        t = re.sub(r"\d+(?:\.\d+){2,}", _dotted, t)
        # both-endpoint unit ranges: 20°C-25°C -> 20摄氏度到25℃ (the dash
        # would otherwise read as a minus on the right endpoint; the single
        # rules below then verbalize each side)
        t = re.sub(r"(?:°C|℃)\s*[-~～]\s*(?=-?\d)", "摄氏度到", t)
        t = re.sub(r"(?:°F|℉)\s*[-~～]\s*(?=-?\d)", "华氏度到", t)
        # temperature ranges first (else the left endpoint loses its unit and
        # the dash reads as a minus): -5~3℃ -> 零下五到三摄氏度
        def _temp_range(unit_word):
            def f(m):
                lo = ("零下" if m.group(1) else "") + zh_num.zh_number(m.group(2))
                hi = ("零下" if m.group(3) else "") + zh_num.zh_number(m.group(4))
                return lo + "到" + hi + unit_word

            return f

        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*[-~～]\s*(-?)(\d+(?:\.\d+)?)\s*(?:°C|℃)",
            _temp_range("摄氏度"), t,
        )
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*[-~～]\s*(-?)(\d+(?:\.\d+)?)\s*(?:°F|℉)",
            _temp_range("华氏度"), t,
        )
        # temperatures: -5°C -> 零下五摄氏度, 37.5℃ -> 三十七点五摄氏度
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*(?:°C|℃)",
            lambda m: ("零下" if m.group(1) else "") + zh_num.zh_number(m.group(2)) + "摄氏度",
            t,
        )
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*(?:°F|℉)",
            lambda m: ("零下" if m.group(1) else "") + zh_num.zh_number(m.group(2)) + "华氏度",
            t,
        )
        # percent ranges first (else the dash reads as a minus on the right
        # endpoint): 50%-60% -> 百分之五十到百分之六十; BOTH endpoints may be
        # signed (-5%~-2% -> 负百分之五到负百分之二). The separator between a
        # left % and a signed right endpoint is ~ only (a dash there is
        # ambiguous with the minus itself).
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*%\s*(?:[~～]\s*(-)|[-~～]\s*)(\d+(?:\.\d+)?)\s*%",
            lambda m: ("负" if m.group(1) else "") + "百分之" + zh_num.zh_number(m.group(2))
            + "到" + ("负" if m.group(3) else "") + "百分之" + zh_num.zh_number(m.group(4)),
            t,
        )
        # percentages: 2.5% -> 百分之二点五, -2.3% -> 负百分之二点三
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*%",
            lambda m: ("负" if m.group(1) else "") + "百分之" + zh_num.zh_number(m.group(2)),
            t,
        )
        # ordinal ranges FIRST (第3-5名): the bare ordinal rule below would
        # strip the left endpoint and leave "-5" to the negative rule (负五)
        t = re.sub(
            r"第(\d+)\s*[-~～]\s*(\d+)",
            lambda m: "第" + zh_num.zh_integer(m.group(1)).replace("两", "二")
            + "到" + zh_num.zh_integer(m.group(2)).replace("两", "二"),
            t,
        )
        # ordinals: 第3 -> 第三 (第 always selects 二, never 两)
        t = re.sub(r"第(\d+)", lambda m: "第" + zh_num.zh_integer(m.group(1)).replace("两", "二"), t)
        # amounts may carry a scale suffix (¥2万, ¥3000万): the unit word
        # goes AFTER the scale (两万元, not 二元万元); bare 2 before a scale
        # reads 两 like the standalone 两-scale rule
        _sc = r"(万亿|亿|万)?"

        def _amt(num, scale):
            txt = zh_num.zh_number(num)
            if scale:
                if txt == "二":
                    txt = "两"
                txt += scale
            return txt

        # currency ranges first (else the single-money rule eats the left
        # endpoint and leaves "-5000" to the negative rule): ¥3000-5000
        t = re.sub(
            r"[¥￥]\s*(\d+(?:\.\d+)?)" + _sc + r"\s*[-~～]\s*[¥￥]?\s*(\d+(?:\.\d+)?)" + _sc,
            lambda m: _amt(m.group(1), m.group(2)) + "到" + _amt(m.group(3), m.group(4)) + "元",
            t,
        )
        t = re.sub(
            r"\$\s*(\d+(?:\.\d+)?)" + _sc + r"\s*[-~～]\s*\$?\s*(\d+(?:\.\d+)?)" + _sc,
            lambda m: _amt(m.group(1), m.group(2)) + "到" + _amt(m.group(3), m.group(4)) + "美元",
            t,
        )
        # money: ¥12999 / ￥12999 / $12.5 / ¥2万
        t = re.sub(
            r"[¥￥]\s*(\d+(?:\.\d+)?)" + _sc,
            lambda m: _amt(m.group(1), m.group(2)) + "元",
            t,
        )
        t = re.sub(
            r"\$\s*(\d+(?:\.\d+)?)" + _sc,
            lambda m: _amt(m.group(1), m.group(2)) + "美元",
            t,
        )
        # trailing plus: 3000+ -> 三千多 (not when another number follows —
        # that is addition, handled by the operator pass above)
        t = re.sub(r"(\d+(?:\.\d+)?)\+(?!\d)", lambda m: zh_num.zh_number(m.group(1)) + "多", t)
        # units: 10km/h -> 每小时十千米
        unit_map = {"km": "千米", "m": "米", "cm": "厘米", "mm": "毫米", "kg": "千克", "g": "克"}
        t = re.sub(
            r"(\d+(?:\.\d+)?)\s*(km|cm|mm|kg|m|g)/h",
            lambda m: "每小时" + zh_num.zh_number(m.group(1)) + unit_map[m.group(2).lower()],
            t,
            flags=re.IGNORECASE,
        )
        # standalone measures: 3.2g -> 三点二克. Lowercase only — uppercase
        # letter suffixes are product/tech names (5G网络, iPhone 2X) that the
        # reference's FSTs leave as letters.
        t = re.sub(
            r"(\d+(?:\.\d+)?)\s*(km|cm|mm|kg|g|m)(?![A-Za-z/])",
            lambda m: zh_num.zh_number(m.group(1)) + unit_map[m.group(2)],
            t,
        )
        # fractions: 1/3 -> 三分之一 (dates and rate units consumed above)
        t = re.sub(
            r"(\d+)/(\d+)",
            lambda m: zh_num.zh_integer(m.group(2)) + "分之" + zh_num.zh_integer(m.group(1)),
            t,
        )
        # ranges: 3-5 / 3~5 -> 三到五 (phones and full dates consumed above)
        t = re.sub(
            r"(\d+(?:\.\d+)?)\s*[-~～]\s*(\d+(?:\.\d+)?)",
            lambda m: zh_num.zh_number(m.group(1)) + "到" + zh_num.zh_number(m.group(2)),
            t,
        )
        # negative numbers: -5 -> 负五 (ranges consumed above)
        t = re.sub(
            r"(?<![\dA-Za-z])-(\d+(?:\.\d+)?)",
            lambda m: "负" + zh_num.zh_number(m.group(1)),
            t,
        )
        # ID-context digit runs (4-7 digits after an identifier noun) read
        # digit-by-digit: 邮编100080 -> 邮编幺零零零八零 (the cardinal
        # reading 十万零八十 is never how a postcode is spoken; >= 8 digits
        # are covered unconditionally below)
        t = re.sub(
            r"(邮编|验证码|编号|工号|账号|卡号|证号|代码)([:：是为]?\s*)(\d{4,7})(?!\d)",
            lambda m: m.group(1) + m.group(2) + zh_num.zh_digits(m.group(3), tel=True),
            t,
        )
        # leading-zero digit runs are codes, not cardinals: 0755 -> 零七五五
        # (a cardinal reading silently drops the zero). Min 3 digits and not
        # before date/time markers so zero-padded 05月-style fragments keep
        # their calendar reading.
        t = re.sub(
            r"(?<![\d.])0\d{2,}(?![\d.月日号年时点分秒])",
            lambda m: zh_num.zh_digits(m.group(0), tel=True),
            t,
        )
        # long digit identifiers (8+ digits) read digit-by-digit with 幺
        t = re.sub(r"\d{8,}", lambda m: zh_num.zh_digits(m.group(0), tel=True), t)
        # letter-attached digit runs are IDs, not cardinals: 京A12345 ->
        # 京A一二三四五 (4+ digits; short ones like A380/GPT4 keep their
        # conventional cardinal reading)
        t = re.sub(
            r"(?<=[A-Za-z])(\d{4,7})(?![\d.])",
            lambda m: zh_num.zh_digits(m.group(1)),
            t,
        )
        # standalone 2 before a hanzi scale word or measure word/counter
        # reads 两 (2万 -> 两万, 2个 -> 两个; 12个 stays 十二个). 年 excluded:
        # duration 2年 conventionally reads 二年 in the tn grammars.
        t = re.sub(r"(?<![\d.])2(?=[万亿千])", "两", t)
        t = re.sub(
            r"(?<![\d.])2(?=[个只件条张位名本辆杯次层间家场台部首封颗棵套顿瓶碗盘双对组群批斤])",
            "两",
            t,
        )
        # remaining numbers -> standard reading
        t = re.sub(r"\d+(?:\.\d+)?", lambda m: zh_num.zh_number(m.group(0)), t)
        return t

    @staticmethod
    def _en_ordinal_words(n: int) -> str:
        """Ordinalize the last word: 21 -> twenty first, 40 -> fortieth
        (shared by the Nst/Nnd ordinal rule and the fraction denominators)."""
        ord_map = {
            "one": "first", "two": "second", "three": "third", "five": "fifth",
            "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
        }
        words = zh_num.en_integer(n).split(" ")
        last = words[-1]
        if last in ord_map:
            words[-1] = ord_map[last]
        elif last.endswith("y"):
            words[-1] = last[:-1] + "ieth"
        else:
            words[-1] = last + "th"
        return " ".join(words)

    def _normalize_en(self, text: str) -> str:
        """English ITN: numbers/times/money/percent -> words (the behavioral
        surface matched is WeTextProcessing's tn.english FST pipeline the
        reference delegates to, ref front.py:100-111)."""
        t = text
        # abbreviation whitelist (tn.english whitelist.tsv behavior): titles
        # before a capitalized name; No. before a number; etc./vs. anywhere
        t = re.sub(r"\bMr\.(?=\s+[A-Z])", "Mister", t)
        t = re.sub(r"\bMrs\.(?=\s+[A-Z])", "Misses", t)
        t = re.sub(r"\bDr\.(?=\s+[A-Z])", "Doctor", t)
        t = re.sub(r"\betc\.", "et cetera", t)
        t = re.sub(r"\bvs\.?(?=\s)", "versus", t)
        t = re.sub(r"\bNo\.\s*(?=\d)", "number ", t)
        t = re.sub(r"\bProf\.(?=\s+[A-Z])", "Professor", t)
        # St. is Saint before a capitalized name, Street after one
        t = re.sub(r"\bSt\.(?=\s+[A-Z])", "Saint", t)
        t = re.sub(r"(?<=[a-z])\s+St\.(?=\s|$)", " Street", t)
        t = re.sub(r"\bAve\.(?=\s|$)", "Avenue", t)
        t = re.sub(r"\bBlvd\.(?=\s|$)", "Boulevard", t)
        t = re.sub(r"(?<=[a-z])\s+Rd\.(?=\s|$)", " Road", t)
        t = re.sub(r"\bJr\.(?=\s|[,.]|$)", "Junior", t)
        t = re.sub(r"\bSr\.(?=\s|[,.]|$)", "Senior", t)
        # a.m./p.m. -> AM/PM early: the dots otherwise survive into the
        # sentence splitter (a '.' token mid-utterance forces a split) and
        # the clock rules below never see a normalized marker
        # lowercase only: 'A.M.' may be a person's initials (A.M. Turing)
        t = re.sub(r"\b([ap])\.m\.", lambda m: m.group(1).upper() + "M", t)
        # electronic (tn.english electronic FST): emails read local at
        # domain dot tld; URLs read their dots/slashes. Digits inside are
        # verbalized by the later digit rules.
        def _email(m):
            local = (m.group(1).replace(".", " dot ").replace("_", " underscore ")
                     .replace("+", " plus ").replace("-", " dash "))
            return local + " at " + m.group(2).replace(".", " dot ")

        t = re.sub(r"\b([A-Za-z0-9._%+-]+)@([A-Za-z0-9-]+(?:\.[A-Za-z0-9-]+)+)\b",
                   _email, t)

        def _url(m):
            u = m.group(0)
            u = re.sub(r"^https://", "H T T P S colon slash slash ", u)
            u = re.sub(r"^http://", "H T T P colon slash slash ", u)
            u = u.replace("www.", "W W W dot ").replace("/", " slash ")
            return u.replace(".", " dot ")

        t = re.sub(
            r"\b(?:https?://|www\.)[A-Za-z0-9-]+(?:\.[A-Za-z0-9-]+)+(?:/[\w./-]*)?",
            _url, t)
        t = re.sub(
            r"\b[A-Za-z0-9-]+\.(?:com|org|net|io|edu|gov|cn|ai|co\.uk)\b(?!\.?[A-Za-z])",
            lambda m: m.group(0).replace(".", " dot "), t)
        # feet-and-inches: 5'11" -> five foot eleven
        t = re.sub(r"(?<!\d)(\d{1,2})'(\d{1,2})(?:\"|”|'')(?!\d)",
                   lambda m: (zh_num.en_integer(int(m.group(1))) + " foot "
                              + zh_num.en_integer(int(m.group(2)))), t)
        # '#5' -> 'number 5' (the cardinal rule verbalizes the digits)
        t = re.sub(r"#(?=\d)", "number ", t)
        # dimensions and multipliers: 4x4 -> four by four; 3x faster ->
        # three times (the × math rule below covers the explicit sign)
        t = re.sub(r"(?<=\d)\s*x\s*(?=\d)", " by ", t)
        t = re.sub(r"\b(\d+(?:\.\d+)?)x\b",
                   lambda m: zh_num.en_number(m.group(1)) + " times", t)
        # math operators between digits: 5×3 -> 5 times 3, 1+1=2 -> plus/equals
        t = re.sub(r"(?<=\d)\s*×\s*(?=\d)", " times ", t)
        t = re.sub(r"(?<=\d)\s*\+\s*(?=\d)", " plus ", t)
        t = re.sub(r"(?<=\d)\s*=\s*(?=[-\d])", " equals ", t)
        # trailing plus: ages 18+ -> eighteen plus (binary plus consumed above)
        t = re.sub(r"(?<=\d)\+(?!\d)", " plus", t)
        # phone/ID formats read digit-by-digit BEFORE any dash->to rewrite:
        # +1 (212) 555-0123 / (800) 555-0199 / SSN 123-45-6789 /
        # 1-800-555-0199 -> one eight zero zero five five five...
        t = re.sub(
            r"\+(\d{1,2})[\s-]?\(?(\d{3})\)?[\s-]?(\d{3})[-.\s]?(\d{4})(?!\d)",
            lambda m: "plus " + zh_num.en_digits("".join(m.groups())),
            t,
        )
        t = re.sub(
            r"\(\s*(\d{3})\s*\)\s*(\d{3})[-.\s]?(\d{4})(?!\d)",
            lambda m: zh_num.en_digits("".join(m.groups())),
            t,
        )
        t = re.sub(
            r"(?<!\d)(\d{3})-(\d{2})-(\d{4})(?!\d)",
            lambda m: zh_num.en_digits("".join(m.groups())),
            t,
        )
        t = re.sub(
            r"(?<!\d)(?:\d-)?\d{3}-\d{3}-\d{4}(?!\d)",
            lambda m: zh_num.en_digits(m.group(0).replace("-", "")),
            t,
        )
        # dotted sequences (versions / IPs): 16.4.1 -> sixteen point four
        # point one; zero-padded or long groups read digit-by-digit
        def _dotted(m):
            parts = m.group(0).split(".")
            if all(len(p) <= 2 and not p.startswith("0") for p in parts):
                return " point ".join(zh_num.en_integer(int(p)) for p in parts)
            return " point ".join(zh_num.en_digits(p) for p in parts)

        t = re.sub(r"\d+(?:\.\d+){2,}", _dotted, t)
        # time ranges: 8:00-22:00 -> eight o'clock to twenty two o'clock
        t = re.sub(r"(?<=\d)\s*[-~]\s*(?=\d{1,2}:\d{2})", " to ", t)
        # clock times: 8:00 AM -> eight AM / 8:30 -> eight thirty
        def _time(m):
            h, mm = int(m.group(1)), m.group(2)
            out = zh_num.en_integer(h)
            if int(mm) == 0:
                out += " o'clock"
            elif int(mm) < 10:
                out += " oh " + zh_num.en_integer(int(mm))
            else:
                out += " " + zh_num.en_integer(int(mm))
            return out

        # H:M:S durations before the clock rule (whose (?!\d) guard lets it
        # eat the H:M of "3:59:58" and leak ",fifty eight"):
        # 3:59:58 -> three fifty nine and fifty eight seconds
        t = re.sub(
            r"(?<!\d)(\d{1,2}):(\d{2}):(\d{2})(?!\d)",
            lambda m: (zh_num.en_integer(int(m.group(1))) + " "
                       + zh_num.en_integer(int(m.group(2))) + " and "
                       + zh_num.en_integer(int(m.group(3))) + " seconds"),
            t,
        )
        t = re.sub(r"(?<!\d)(\d{1,2}):(\d{2})(?!\d)", _time, t)
        # leftover digit colons are scores/ratios (clock times consumed above)
        t = re.sub(
            r"(?<!\d)(\d+):(\d+)(?!\d)",
            lambda m: zh_num.en_number(m.group(1)) + " to " + zh_num.en_number(m.group(2)),
            t,
        )
        # ISO dates YYYY-MM-DD read as dates, not numeric ranges: rewrite to
        # 'month DAYth YEAR' BEFORE the dash->to pass; the ordinal and year
        # rules below then verbalize the pieces (WeTextProcessing's
        # tn.english date FST is the behavior being matched)
        _MONTHS = ("january", "february", "march", "april", "may", "june",
                   "july", "august", "september", "october", "november",
                   "december")

        def _ord_suffix(n):
            if n % 100 in (11, 12, 13):
                return "th"
            return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")

        t = re.sub(
            r"\b((?:19|20)\d{2})-(0?[1-9]|1[0-2])-(0?[1-9]|[12]\d|3[01])\b",
            lambda m: (f"{_MONTHS[int(m.group(2)) - 1]} "
                       f"{int(m.group(3))}th {m.group(1)}"),
            t,
        )
        # US slash dates M/D/YYYY -> 'month DAYth YEAR' (same downstream
        # verbalization as the ISO rule)
        t = re.sub(
            r"\b(0?[1-9]|1[0-2])/(0?[1-9]|[12]\d|3[01])/((?:19|20)\d{2})\b",
            lambda m: (f"{_MONTHS[int(m.group(1)) - 1]} {int(m.group(2))}"
                       f"{_ord_suffix(int(m.group(2)))} {m.group(3)}"),
            t,
        )

        # month-name dates: 'July 4, 1776' -> 'July 4th 1776' (day
        # ordinalized, comma dropped, year left for the year rule); a day
        # that already carries a suffix is normalized to the correct one
        def _month_day(m):
            day = int(m.group(2))
            out = f"{m.group(1)} {day}{_ord_suffix(day)}"
            if m.group(3):
                out += f" {m.group(3)}"
            return out

        t = re.sub(
            r"\b(" + "|".join(_MONTHS) + r")\s+(\d{1,2})(?:st|nd|rd|th)?\b"
            r"(?:,?\s*((?:1[5-9]|20)\d{2})\b)?",
            _month_day, t, flags=re.IGNORECASE,
        )
        # fractions (tn.english fraction FST): 1/2 -> one half, 3/4 ->
        # three quarters, 2/3 -> two thirds; 24/7 is read as-is; slash
        # dates were consumed above, multi-part slashes are left alone
        t = re.sub(r"\b24/7\b", "twenty four seven", t)

        def _fraction(m):
            num, den = int(m.group(1)), int(m.group(2))
            if den == 2:
                word = "half" if num == 1 else "halves"
            elif den == 4:
                word = "quarter" + ("" if num == 1 else "s")
            else:
                word = self._en_ordinal_words(den) + ("" if num == 1 else "s")
            return zh_num.en_integer(num) + " " + word

        t = re.sub(r"(?<![\d./])([1-9]\d?)/(1[0-2]|[2-9])(?![\d/])", _fraction, t)
        # generic numeric ranges: rewrite the dash to " to " BEFORE unit
        # rules consume the endpoints (1990-1995, 50%-60%, $300-$500 — the
        # zh path rewrites ranges first for the same reason); the endpoints
        # then verbalize through their own year/percent/money rules
        t = re.sub(r"(?<=[\d%])\s*[-~]\s*(?=[$\d])", " to ", t)

        # money BEFORE the year rule: a one-char lookbehind on the year rule
        # cannot guard "$ 1999" (the money regexes accept \s*), so dollar
        # amounts must be consumed first. Comma-aware ("$1,990") because the
        # generic comma strip runs only after the year rule.
        _MONEY_NUM = r"(\d{1,3}(?:,\d{3})+|\d+(?:\.\d+)?)"

        # scaled money FIRST: '$5 million' -> 'five million dollars' (the
        # unit migrates past the scale word), '$1.5B' -> 'one point five
        # billion dollars'
        def _money_scale(m):
            num = m.group(1).replace(",", "")
            scale = {"K": "thousand", "M": "million", "B": "billion",
                     "T": "trillion"}.get(m.group(2), m.group(2).lower())
            return f"{zh_num.en_number(num)} {scale} dollars"

        t = re.sub(r"\$\s*" + _MONEY_NUM
                   + r"\s*(thousand|million|billion|trillion)\b",
                   _money_scale, t, flags=re.IGNORECASE)
        t = re.sub(r"\$\s*" + _MONEY_NUM + r"\s*([KMBT])\b", _money_scale, t)

        def _dollars_cents(m):
            d, c = int(m.group(1).replace(",", "")), int(m.group(2))
            cents = zh_num.en_integer(c) + (" cent" if c == 1 else " cents")
            if d == 0:
                return cents
            dollars = zh_num.en_integer(d) + (" dollar" if d == 1 else " dollars")
            return f"{dollars} and {cents}"

        t = re.sub(r"\$\s*(\d{1,3}(?:,\d{3})+|\d+)\.(\d{2})(?!\d)", _dollars_cents, t)

        def _dollars(m):
            num = m.group(1).replace(",", "")
            word = zh_num.en_number(num)
            unit = "dollar" if num in ("1", "1.0") else "dollars"
            return f"{word} {unit}"

        t = re.sub(r"\$\s*" + _MONEY_NUM, _dollars, t)

        # euro / sterling with sub-units (tn.english money FST covers the
        # major currency symbols): €19.99 -> nineteen euros and ninety nine
        # cents; £3.50 -> three pounds and fifty pence
        def _currency(sym, unit_one, unit_many, cent_one, cent_many):
            def whole(m):
                num = m.group(1).replace(",", "")
                unit = unit_one if num in ("1", "1.0") else unit_many
                return f"{zh_num.en_number(num)} {unit}"

            def cents(m):
                d, c = int(m.group(1).replace(",", "")), int(m.group(2))
                cc = zh_num.en_integer(c) + " " + (cent_one if c == 1 else cent_many)
                if d == 0:
                    return cc
                dd = zh_num.en_integer(d) + " " + (unit_one if d == 1 else unit_many)
                return f"{dd} and {cc}"

            nonlocal t
            t = re.sub(sym + r"\s*(\d{1,3}(?:,\d{3})+|\d+)\.(\d{2})(?!\d)", cents, t)
            t = re.sub(sym + r"\s*" + _MONEY_NUM, whole, t)

        _currency(r"€", "euro", "euros", "cent", "cents")
        _currency(r"£", "pound", "pounds", "penny", "pence")

        # decades BEFORE the year rule ('1990' inside '1990s' is not a
        # standalone year, and the generic number rule would read the
        # trailing s as a stray letter): the 1990s -> the nineteen
        # nineties; the '90s / 90s -> the nineties
        def _decadeify(words):
            parts = words.split(" ")
            parts[-1] = (parts[-1][:-1] + "ies" if parts[-1].endswith("y")
                         else parts[-1] + "s")
            return " ".join(parts)

        t = re.sub(r"\b(1[5-9]\d0|20\d0)s\b",
                   lambda m: _decadeify(zh_num.en_year(int(m.group(1)))), t)
        t = re.sub(r"['’]?\b([2-9]0)s\b",
                   lambda m: _decadeify(zh_num.en_integer(int(m.group(1)))), t)
        # years (4-digit standalone, 1500-2099) BEFORE the comma strip:
        # an explicitly comma-grouped "1,990" is a cardinal, and stripping
        # its comma first would let this rule misread it as a year. Unit
        # guards keep 1990% / 1750°C on their own rules below.
        t = re.sub(
            r"(?<![$€£])\b(1[5-9]\d{2}|20\d{2})\b(?!\s*[%°℃℉])",
            lambda m: zh_num.en_year(int(m.group(1))),
            t,
        )
        # thousands separators: 100,000 -> 100000 (whole-number match; see zh)
        t = re.sub(
            r"(?<![\d.])\d{1,3}(?:,\d{3})+(?![\d,])",
            lambda m: m.group(0).replace(",", ""),
            t,
        )
        # measures (tn.english measure FST): digit + unit symbol -> spoken
        # unit, singular at exactly 1, '/s' -> 'per second'. Longest symbols
        # first so km/h does not stop at km; single-letter 'g' keeps a word
        # boundary so serials like 'a94a8f' stay intact.
        _UNIT_WORDS = [
            ("km/h", "kilometer per hour", "kilometers per hour"),
            ("kWh", "kilowatt hour", "kilowatt hours"),
            ("mAh", "milliamp hour", "milliamp hours"),
            ("mph", "mile per hour", "miles per hour"),
            ("GHz", "gigahertz", "gigahertz"),
            ("MHz", "megahertz", "megahertz"),
            ("kHz", "kilohertz", "kilohertz"),
            ("Hz", "hertz", "hertz"),
            ("GB", "gigabyte", "gigabytes"),
            ("MB", "megabyte", "megabytes"),
            ("TB", "terabyte", "terabytes"),
            ("KB", "kilobyte", "kilobytes"),
            ("km", "kilometer", "kilometers"),
            ("cm", "centimeter", "centimeters"),
            ("mm", "millimeter", "millimeters"),
            ("kg", "kilogram", "kilograms"),
            ("mg", "milligram", "milligrams"),
            ("ml", "milliliter", "milliliters"),
            ("ms", "millisecond", "milliseconds"),
            ("lbs", "pound", "pounds"),
            ("lb", "pound", "pounds"),
            ("oz", "ounce", "ounces"),
            ("g", "gram", "grams"),
        ]
        _UNIT_MAP = {sym: (one, many) for sym, one, many in _UNIT_WORDS}

        def _measure(m):
            num = m.group(1)
            one, many = _UNIT_MAP[m.group(2)]
            out = zh_num.en_number(num) + " " + (one if num in ("1", "1.0") else many)
            if m.group(3):
                out += " per second"
            return out

        t = re.sub(
            r"(\d+(?:\.\d+)?)\s*("
            + "|".join(re.escape(s) for s, _, _ in _UNIT_WORDS)
            + r")(/s)?\b(?![A-Za-z])",
            _measure, t,
        )
        # version/model suffixes: CosyVoice2 -> CosyVoice 2 (read as a word +
        # a number, the reference FSTs' behavior per front.py:470 comments).
        # Only whole letters-then-digits tokens split, so identifiers with
        # interleaved digits (sha1 hashes, serials like "a94a8f") stay intact.
        t = re.sub(r"(?<![A-Za-z0-9])([A-Za-z]+)(\d+)(?![A-Za-z0-9])", r"\1 \2", t)
        # percent (sign-aware: the negative rule runs LAST, after this rule
        # has consumed the digits — "-2.5%" must keep its minus here)
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*%",
            lambda m: ("minus " if m.group(1) else "")
            + zh_num.en_number(m.group(2)) + " percent",
            t,
        )
        # (money rules run earlier, before the year rule — see above)
        # temperatures: 25°C -> twenty five degrees Celsius
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*(?:°C|℃)",
            lambda m: ("minus " if m.group(1) else "") + zh_num.en_number(m.group(2)) + " degrees Celsius",
            t,
        )
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*(?:°F|℉)",
            lambda m: ("minus " if m.group(1) else "") + zh_num.en_number(m.group(2)) + " degrees Fahrenheit",
            t,
        )
        # bare degree sign (no C/F): -40° -> minus forty degrees
        t = re.sub(
            r"(-?)(\d+(?:\.\d+)?)\s*°(?![CcFf])",
            lambda m: ("minus " if m.group(1) else "") + zh_num.en_number(m.group(2)) + " degrees",
            t,
        )
        # ordinal ranges: 2nd-3rd -> second to third (the generic dash->to
        # pre-pass requires a digit before the dash and cannot see these)
        t = re.sub(r"\b(\d{1,2})(st|nd|rd|th)\s*-\s*(?=\d)", r"\1\2 to ", t)
        # ordinals 1st/2nd/3rd/4th...
        t = re.sub(r"\b(\d+)(?:st|nd|rd|th)\b",
                   lambda m: self._en_ordinal_words(int(m.group(1))), t)
        # (plain digit ranges like 'pages 3-5' were already rewritten to
        # ' to ' by the dash pre-pass above — no second range rule needed)
        # negatives: -5 -> minus five (ranges consumed above)
        t = re.sub(
            r"(?<![\dA-Za-z])-(\d+(?:\.\d+)?)",
            lambda m: "minus " + zh_num.en_number(m.group(1)),
            t,
        )
        # zero-leading codes/IDs read digit-by-digit (agent 007, code 0042 —
        # a leading zero is never a cardinal)
        t = re.sub(r"(?<![\d.])0\d+(?![\d.])",
                   lambda m: zh_num.en_digits(m.group(0)), t)
        # remaining numbers
        t = re.sub(r"\d+(?:\.\d+)?", lambda m: zh_num.en_number(m.group(0)), t)
        return t

    # -- orchestration -------------------------------------------------------
    def normalize(self, text: str) -> str:
        """Route zh/en, protect pinyin tones + joined Chinese names from the
        digit verbalizers, then apply the punctuation replacement map."""
        if not self.loaded:
            print("Error, text normalizer is not initialized !!!")
            return ""
        route_zh = self.use_chinese(text)
        text = re.sub(self.ENGLISH_CONTRACTION_PATTERN, r"\1 is", text, flags=re.IGNORECASE)
        # a verbalizer bug must degrade, never abort the request (the
        # reference wraps both normalizer calls the same way, front.py:
        # 128-146; it falls en back to raw text and zh to "" — degrading zh
        # to the un-verbalized text keeps the utterance, strictly more
        # useful than the reference's empty string)
        if not route_zh:
            try:
                result = self._normalize_en(text)
            except Exception as e:
                print(f"Warning: en normalization failed ({e}); using raw text")
                result = text
            return self._en_rep_re.sub(lambda m: self.char_rep_map[m.group()], result)
        masked, pinyins = self.save_pinyin_tones(text.rstrip())
        masked, names = self.save_names(masked)
        try:
            result = self._normalize_zh(masked)
        except Exception as e:
            print(f"Warning: zh normalization failed ({e}); using raw text")
            result = masked
        result = self.restore_names(result, names)
        result = self.restore_pinyin_tones(result, pinyins)
        return self._zh_rep_re.sub(lambda m: self.zh_char_rep_map[m.group()], result)


class TextTokenizer:
    """SentencePiece BPE tokenizer with CJK pre-tokenization and sentence
    splitting (behavioral reference: front.py:231-428)."""

    # tokens that end a sentence (plus their leading-space BPE variants)
    punctuation_marks_tokens = [".", "!", "?", "▁.", "▁?", "▁..."]
    # a sentence mark directly followed by one of these never splits
    _QUOTE_TOKENS = ("'", "▁'")

    def __init__(self, vocab_file: str = None, normalizer: TextNormalizer = None, sp_model=None):
        self.vocab_file = vocab_file
        self.normalizer = normalizer
        if sp_model is None:
            if vocab_file is None:
                raise ValueError("vocab_file is None")
            if not os.path.exists(vocab_file):
                raise ValueError(f"vocab_file {vocab_file} does not exist")
            sp_model = SentencePieceProcessor(model_file=vocab_file)
        self.sp_model = sp_model
        if self.normalizer:
            self.normalizer.load()
        self.pre_tokenizers = [tokenize_by_CJK_char]

    # -- vocab / special-token surface (reference API contract) --------------
    @property
    def vocab_size(self):
        return self.sp_model.GetPieceSize()

    @property
    def unk_token(self):
        return "<unk>"

    @property
    def pad_token(self):
        return None

    @property
    def bos_token(self):
        return "<s>"

    @property
    def eos_token(self):
        return "</s>"

    @property
    def pad_token_id(self):
        return -1

    @property
    def bos_token_id(self):
        return 0

    @property
    def eos_token_id(self):
        return 1

    @property
    def unk_token_id(self):
        return self.sp_model.unk_id()

    @property
    def special_tokens_map(self):
        return {
            "unk_token": self.unk_token,
            "pad_token": self.pad_token,
            "bos_token": self.bos_token,
            "eos_token": self.eos_token,
        }

    def get_vocab(self):
        return {self.convert_ids_to_tokens(i): i for i in range(self.vocab_size)}

    def convert_ids_to_tokens(self, ids: Union[List[int], int]):
        return self.sp_model.IdToPiece(ids)

    def convert_tokens_to_ids(self, tokens: Union[List[str], str]) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.sp_model.PieceToId(t) for t in tokens]

    # -- encode / decode -----------------------------------------------------
    def _preprocess(self, text: str) -> str:
        if self.normalizer:
            text = self.normalizer.normalize(text)
        for pre in self.pre_tokenizers:
            text = pre(text)
        return text

    def tokenize(self, text: str) -> List[str]:
        return self.encode(text, out_type=str)

    def encode(self, text: str, **kwargs):
        out_type = kwargs.pop("out_type", int)
        if len(text) == 0:
            return []
        # single visible chars bypass normalization (punctuation-only inputs
        # would otherwise be rewritten away)
        if len(text.strip()) != 1:
            text = self._preprocess(text)
        return self.sp_model.Encode(text, out_type=out_type, **kwargs)

    def batch_encode(self, texts: List[str], **kwargs):
        out_type = kwargs.pop("out_type", int)
        return self.sp_model.Encode(
            [self._preprocess(t) for t in texts], out_type=out_type, **kwargs
        )

    def decode(self, ids: Union[List[int], int], do_lower_case=False, **kwargs):
        out_type = kwargs.pop("out_type", str)
        seq = [ids] if isinstance(ids, int) else ids
        text = self.sp_model.Decode(seq, out_type=out_type, **kwargs)
        return de_tokenized_by_CJK_char(text, do_lower_case=do_lower_case)

    # -- sentence splitting ----------------------------------------------------
    @staticmethod
    def split_sentences_by_token(
        tokenized_str: List[str], split_tokens: List[str], max_tokens_per_sentence: int
    ) -> List[List[str]]:
        """Cut a token stream into sentences at `split_tokens`; a run that
        grows past the budget without a boundary is re-split on commas, then
        dashes, then hard-chunked; adjacent short sentences are re-merged up
        to the budget (behavioral reference: front.py:348-423)."""
        sentences: List[List[str]] = []
        buf: List[str] = []
        for pos, tok in enumerate(tokenized_str):
            buf.append(tok)
            if len(buf) > max_tokens_per_sentence:
                sentences.extend(
                    TextTokenizer._split_overflow(buf, split_tokens, max_tokens_per_sentence)
                )
                buf = []
                continue
            if tok not in split_tokens or len(buf) <= 2:
                continue
            nxt = tokenized_str[pos + 1] if pos + 1 < len(tokenized_str) else None
            if nxt in TextTokenizer._QUOTE_TOKENS:
                continue  # quoted speech: keep the closing quote attached
            sentences.append(buf)
            buf = []
        if buf:
            sentences.append(buf)
        return TextTokenizer._merge_short_sentences(sentences, max_tokens_per_sentence)

    @staticmethod
    def _split_overflow(buf: List[str], split_tokens: List[str], limit: int) -> List[List[str]]:
        """Fallback chain for an over-budget run with no sentence boundary."""
        commas = (",", "▁,")
        if not any(c in split_tokens for c in commas) and any(t in commas for t in buf):
            return TextTokenizer.split_sentences_by_token(buf, list(commas), limit)
        if "-" not in split_tokens and "-" in buf:
            return TextTokenizer.split_sentences_by_token(buf, ["-"], limit)
        warnings.warn(
            f"[WARNING] Sentence token length exceeds max ({limit}): {buf}",
            RuntimeWarning,
        )
        return [buf[k : k + limit] for k in range(0, len(buf), limit)]

    @staticmethod
    def _merge_short_sentences(sentences: List[List[str]], max_len: int) -> List[List[str]]:
        merged: List[List[str]] = []
        for sent in sentences:
            if merged and len(merged[-1]) + len(sent) <= max_len:
                merged[-1] = merged[-1] + sent
            else:
                merged.append(sent)
        return merged

    def split_sentences(self, tokenized: List[str], max_tokens_per_sentence=120) -> List[List[str]]:
        return TextTokenizer.split_sentences_by_token(
            tokenized, self.punctuation_marks_tokens, max_tokens_per_sentence
        )
