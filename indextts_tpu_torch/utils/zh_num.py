"""Chinese and English number verbalization for the text normalizer.

The reference delegates to WeTextProcessing's pynini FSTs
(indextts/utils/front.py:100-111); this is a self-contained rule-based
re-implementation of the readings those FSTs produce for the constructs the
IndexTTS frontend test-suite exercises (front.py:436-481): integers, decimals,
percentages, years, dates, clock times, phone numbers, money, and ranges.
"""

from __future__ import annotations

import re

ZH_DIGITS = "零一二三四五六七八九"
ZH_UNITS = ["", "十", "百", "千"]
ZH_GROUPS = ["", "万", "亿", "万亿"]
# phone/ID digit reading uses 幺 for 1
ZH_TEL_DIGITS = "零幺二三四五六七八九"


def zh_digits(s: str, tel: bool = False) -> str:
    table = ZH_TEL_DIGITS if tel else ZH_DIGITS
    return "".join(table[int(c)] if c.isdigit() else c for c in s)


def _read_group(num: int) -> str:
    """Read a 0..9999 group, without leading-zero context handling.

    二/两 selection follows the common Mandarin TTS convention (the
    reference's WeTextProcessing FSTs encode the same rule): 2 in the
    thousands place reads 两 (12999 -> 一万两千九百九十九), while 二 is kept
    in the hundreds/tens/ones places (220 -> 二百二十).
    """
    if num == 0:
        return ""
    out = []
    digits = [int(d) for d in str(num)]
    n = len(digits)
    prev_zero = False
    for i, d in enumerate(digits):
        unit = ZH_UNITS[n - 1 - i]
        if d == 0:
            prev_zero = True
            continue
        if prev_zero and out:
            out.append("零")
        prev_zero = False
        hanzi = "两" if (d == 2 and unit == "千") else ZH_DIGITS[d]
        out.append(hanzi + unit)
    return "".join(out)


def zh_integer(num_str: str, simplify_teen: bool = True) -> str:
    """Read an integer string in standard Chinese grouping (万/亿)."""
    num_str = num_str.lstrip("+")
    neg = num_str.startswith("-")
    if neg:
        num_str = num_str[1:]
    num_str = num_str or "0"
    n = int(num_str)
    if n == 0:
        return "负零" if neg else "零"
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    if len(groups) > len(ZH_GROUPS):
        # beyond 万亿 (>= 10^16) there is no standard group word: read
        # digit-by-digit like the long-digit-string fallback, instead of
        # IndexError-ing out of the whole normalize() call
        return ("负" if neg else "") + zh_digits(str(int(num_str)))
    out = []
    prev_gi = None  # most recent EMITTED group index
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        text = _read_group(g)
        # a bare 2 directly before 万/亿 reads 两 (20000 -> 两万)
        if text == "二" and gi > 0:
            text = "两"
        # inter-group zero, two cases: leading zeros inside this group
        # (100001 -> 十万零一) or whole zero group(s) skipped since the
        # last emitted group (100005000 -> 一亿零五千)
        if out and (groups[gi] < 1000 or prev_gi - gi > 1):
            out.append("零")
        out.append(text + ZH_GROUPS[gi])
        prev_gi = gi
    res = "".join(out)
    # 一十X -> 十X for standalone 10..19
    if simplify_teen and res.startswith("一十"):
        res = res[1:]
    return ("负" if neg else "") + res


def zh_number(num_str: str) -> str:
    """Read an integer or decimal."""
    num_str = num_str.strip()
    if "." in num_str:
        int_part, frac = num_str.split(".", 1)
        frac = frac.rstrip()
        head = zh_integer(int_part) if int_part not in ("", "-", "+") else ("负零" if int_part == "-" else "零")
        return head + "点" + zh_digits(frac)
    return zh_integer(num_str)


# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

EN_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
EN_SCALES = [
    (10**12, "trillion"), (10**9, "billion"), (10**6, "million"),
    (10**3, "thousand"), (100, "hundred"),
]


def en_integer(n: int) -> str:
    if n < 0:
        return "minus " + en_integer(-n)
    if n < 20:
        return EN_UNITS[n]
    if n < 100:
        t, r = divmod(n, 10)
        return EN_TENS[t] + ("" if r == 0 else " " + EN_UNITS[r])
    for scale, name in EN_SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = en_integer(head) + " " + name
            if rest:
                out += " " + en_integer(rest)
            return out
    return str(n)


def en_digits(s: str) -> str:
    return " ".join(EN_UNITS[int(c)] if c.isdigit() else c for c in s)


def en_number(num_str: str) -> str:
    num_str = num_str.strip()
    if "." in num_str:
        int_part, frac = num_str.split(".", 1)
        head = en_integer(int(int_part)) if int_part not in ("", "-", "+") else "zero"
        return head + " point " + en_digits(frac)
    return en_integer(int(num_str))


def en_year(n: int) -> str:
    """Read a 4-digit year the spoken way (1984 -> nineteen eighty four)."""
    if 1000 <= n <= 9999 and n % 1000 != 0:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return en_integer(hi) + " hundred"
        if lo < 10:
            return en_integer(hi) + " oh " + en_integer(lo)
        return en_integer(hi) + " " + en_integer(lo)
    return en_integer(n)
