"""English transcript cleaning for char models (port of
conformer_nemo_tpu/data/cleaners.py, the char tokenizer's "en" parser).

Parity target: the reference ENCharParser pipeline
(`nemo/collections/common/parts/preprocessing/parsers.py:128` →
`cleaners.py:145` `clean_text`): ascii-fold → lowercase → whitespace
collapse → number expansion → abbreviation expansion → punctuation
replacement ({+, &, %} worded, the rest → space).

Differences (documented, dependency-free):
  * ascii folding uses NFKD + combining-mark strip instead of `unidecode`
    (covers Latin scripts; symbol transliterations differ for exotica).
  * number-to-words is a self-contained implementation matching
    `inflect.number_to_words` output format for cardinals (with comma
    grouping and British "and"), ordinals, decimals and times — the cases
    the reference's NumberCleaner regexes can produce.
"""

from __future__ import annotations

import re
import string as _string
import unicodedata

# --- number words -----------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand")]

_ORD_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    t, o = divmod(n, 10)
    return _TENS[t] + (f"-{_ONES[o]}" if o else "")


def _under_1000(n: int) -> str:
    h, rest = divmod(n, 100)
    parts = []
    if h:
        parts.append(f"{_ONES[h]} hundred")
    if rest:
        # inflect uses British "and" inside a hundred group
        parts.append(("and " if h else "") + _under_100(rest))
    return " ".join(parts) if parts else _ONES[0]


def _cardinal(n: int) -> str:
    """Matches inflect.number_to_words group format: comma-separated scale
    groups, "and" before a <100 tail (e.g. 1234 ->
    'one thousand, two hundred and thirty-four')."""
    if n < 0:
        return "minus " + _cardinal(-n)
    if n < 1000:
        return _under_1000(n)
    groups = []
    for base, name in _SCALES:
        if n >= base:
            q, n = divmod(n, base)
            groups.append(f"{_cardinal(q)} {name}")
    if n:
        if n < 100 and groups:
            groups[-1] += f" and {_under_100(n)}"
        else:
            groups.append(_under_1000(n))
    return ", ".join(groups)


def _ordinal_from_cardinal(words: str) -> str:
    """twenty-one -> twenty-first, etc. (applies to the last word)."""
    head, sep, last = words.rpartition("-")
    if not sep:
        head, sep, last = words.rpartition(" ")
    if last in _ORD_SPECIAL:
        o = _ORD_SPECIAL[last]
    elif last.endswith("y"):
        o = last[:-1] + "ieth"
    else:
        o = last + "th"
    return head + sep + o


def number_to_words(num) -> str:
    """Cardinal/decimal/ordinal-string to words (inflect-compatible for the
    shapes the cleaner feeds it)."""
    s = str(num).strip()
    # inflect tolerates stray non-numeric characters (e.g. '$5'); keep only
    # the numeric part + ordinal suffix
    m0 = re.search(r"[0-9][0-9,.]*(st|nd|rd|th)?", s)
    s = m0.group(0) if m0 else "0"
    m = re.fullmatch(r"([0-9,]+)(st|nd|rd|th)", s)
    if m:
        n = int(m.group(1).replace(",", ""))
        return _ordinal_from_cardinal(_cardinal(n))
    if "." in s:
        whole, _, frac = s.partition(".")
        words = _cardinal(int(whole.replace(",", "") or "0")) + " point"
        for d in frac:
            words += f" {_ONES[int(d)]}"
        return words
    return _cardinal(int(s.replace(",", "") or "0"))


# --- cleaning pipeline (reference cleaners.py:22-260) ------------------------

NUM_CHECK = re.compile(r"([$]?)(^|\s)(\S*[0-9]\S*)(?=(\s|$)((\S*)(\s|$))?)")
TIME_CHECK = re.compile(r"([0-9]{1,2}):([0-9]{2})(am|pm)?")
CURRENCY_CHECK = re.compile(r"\$")
ORD_CHECK = re.compile(r"([0-9]+)(st|nd|rd|th)")
THREE_CHECK = re.compile(r"([0-9]{3})([.,][0-9]{1,2})?([!.?])?$")
DECIMAL_CHECK = re.compile(r"([.,][0-9]{1,2})$")

ABBREVIATIONS = [
    ("ms", "miss"), ("mrs", "misess"), ("mr", "mister"), ("messrs", "messeurs"),
    ("dr", "doctor"), ("drs", "doctors"), ("st", "saint"), ("co", "company"),
    ("jr", "junior"), ("sr", "senior"), ("rev", "reverend"), ("hon", "honorable"),
    ("sgt", "sergeant"), ("capt", "captain"), ("maj", "major"), ("col", "colonel"),
    ("lt", "lieutenant"), ("gen", "general"), ("prof", "professor"),
    ("lb", "pounds"), ("rep", "representative"), ("st", "street"),
    ("ave", "avenue"), ("etc", "et cetera"), ("jan", "january"),
    ("feb", "february"), ("mar", "march"), ("apr", "april"), ("jun", "june"),
    ("jul", "july"), ("aug", "august"), ("sep", "september"), ("oct", "october"),
    ("nov", "november"), ("dec", "december"),
]
_ABBREV_RES = [(re.compile(r"\b%s\." % k), v) for k, v in ABBREVIATIONS]

PUNCTUATION_TO_REPLACE = {"+": "plus", "&": "and", "%": "percent"}


def _ascii_fold(text: str) -> str:
    out = unicodedata.normalize("NFKD", text)
    return "".join(c for c in out if not unicodedata.combining(c))


class _NumberCleaner:
    """Stateful multi-group number assembly (reference NumberCleaner:186)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.curr_num = []
        self.currency = None

    def _final(self, whole_num: str, decimal):
        if self.currency:
            out = number_to_words(whole_num)
            out += " dollar" if whole_num == "1" else " dollars"
            if decimal:
                out += " and " + number_to_words(decimal)
                out += " cent" if whole_num == decimal else " cents"
            self.reset()
            return out
        self.reset()
        if decimal:
            return number_to_words(whole_num + "." + decimal)
        return re.sub(r"[0-9,]+", lambda m: f" {number_to_words(m.group(0))} ", whole_num)

    def clean(self, match: re.Match) -> str:
        ws, number = match.group(2), match.group(3)
        tm = TIME_CHECK.match(number)
        if tm:
            mins = int(tm.group(2))
            out = ws + number_to_words(tm.group(1))
            if mins != 0:
                out += " " + number_to_words(tm.group(2))
            if tm.group(3):
                out += " " + tm.group(3)
            return out
        om = ORD_CHECK.match(number)
        if om:
            return ws + number_to_words(om.group(0))
        if self.currency is None:
            self.currency = match.group(1) or CURRENCY_CHECK.match(number)
        if THREE_CHECK.match(match.group(6) or ""):
            self.curr_num.append(number)
            return " "
        whole_num = "".join(self.curr_num) + number
        decimal = None
        dm = DECIMAL_CHECK.search(whole_num)
        if dm:
            decimal = dm.group(1)[1:]
            whole_num = whole_num[: -len(decimal) - 1]
        whole_num = re.sub(r"\.", "", whole_num)
        return ws + self._final(whole_num, decimal)


def make_table(labels) -> dict:
    punctuation = _string.punctuation
    for ch in PUNCTUATION_TO_REPLACE:
        punctuation = punctuation.replace(ch, "")
    for label in labels:
        punctuation = punctuation.replace(label, "")
    return str.maketrans(punctuation, " " * len(punctuation))


def clean_text(text: str, table) -> str:
    text = _ascii_fold(text)
    text = text.lower()
    text = re.sub(r"\s+", " ", text)
    text = NUM_CHECK.sub(_NumberCleaner().clean, text)
    for regex, replacement in _ABBREV_RES:
        text = regex.sub(replacement, text)
    for punc, replacement in PUNCTUATION_TO_REPLACE.items():
        text = re.sub(re.escape(punc), f" {replacement} ", text)
    if table:
        text = text.translate(table)
    return re.sub(r"\s+", " ", text).strip()
