"""English text normalizer for WER evaluation.

The port's own copy of `whisper_tpu/eval/normalizer.py` (pure Python, no
JAX), so that `whisper_tpu_torch` imports nothing of the JAX package;
tests/test_torch_eval.py holds the two equal.

A from-spec reimplementation of the OpenAI Whisper English normalizer
pipeline (openai/whisper normalizers/{basic,english}.py -- the de-facto
standard preprocessing behind every published Whisper WER number, including
the BASELINE.md "<=0.1 absolute WER delta on LibriSpeech" target). The
reference repo ships no evaluation at all; without these rules LibriSpeech
WER can differ by whole points from published numbers (e.g. "mr." vs
"mister", "1964" vs "nineteen sixty four").

Pipeline (EnglishTextNormalizer):
  1. lowercase; drop bracketed/parenthesized asides and filler words
  2. expand contractions and title abbreviations (mr -> mister, won't ->
     will not, 're -> are, ...)
  3. spell out numbers as digits (EnglishNumberNormalizer): cardinals,
     ordinals, decimals via "point", currency and percent symbols,
     minus/negative prefixes, digit sequences ("one two three" -> "123")
  4. standardize British spellings to American (curated wordlist -- the
     upstream uses a ~1700-entry JSON; this list covers the high-frequency
     head, applied identically to hypothesis and reference)
  5. strip non-numeric symbols, collapse whitespace

This is an offline reimplementation of the published algorithm, not a copy;
behavior on the constructs above is locked by tests/test_eval_batch_ckpt.py
(for the JAX package's copy) and tests/test_torch_eval.py (for this one).
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Union


class BasicTextNormalizer:
    """Language-agnostic: lowercase, drop bracketed text and punctuation."""

    def __init__(self, split_letters: bool = False):
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = re.sub(r"[^\w\s]", " ", s)
        if self.split_letters:
            s = " ".join(s.replace(" ", ""))
        return re.sub(r"\s+", " ", s).strip()


# ----------------------------------------------------------------------------
# Numbers
# ----------------------------------------------------------------------------

_ONES: Dict[str, int] = {
    name: i
    for i, name in enumerate(
        ["one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"],
        start=1,
    )
}
_TENS: Dict[str, int] = {
    name: 10 * (i + 2)
    for i, name in enumerate(
        ["twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
    )
}
_MULTIPLIERS: Dict[str, int] = {
    "hundred": 100,
    "thousand": 1_000,
    "million": 1_000_000,
    "billion": 1_000_000_000,
    "trillion": 1_000_000_000_000,
    "quadrillion": 10**15,
    "quintillion": 10**18,
}
_ZEROS = {"o", "oh", "zero"}

_ORDINAL_IRREGULAR = {
    "first": (1, "st"), "second": (2, "nd"), "third": (3, "rd"),
    "fifth": (5, "th"), "eighth": (8, "th"), "ninth": (9, "th"),
    "twelfth": (12, "th"),
}


def _ordinal_maps():
    ones_ord: Dict[str, tuple] = dict(_ORDINAL_IRREGULAR)
    for name, v in _ONES.items():
        if name not in ("one", "two", "three", "five", "eight", "nine",
                        "twelve"):
            ones_ord[name + "th"] = (v, "th")
    tens_ord = {name[:-1] + "ieth": (v, "th") for name, v in _TENS.items()}
    mult_ord = {name + "th": (v, "th") for name, v in _MULTIPLIERS.items()}
    return ones_ord, tens_ord, mult_ord


_ONES_ORDINAL, _TENS_ORDINAL, _MULT_ORDINAL = _ordinal_maps()
_ONES_PLURAL = {name + "s": (v, "s") for name, v in _ONES.items()}
_TENS_PLURAL = {name[:-1] + "ies": (v, "s") for name, v in _TENS.items()}
_MULT_PLURAL = {name + "s": (v, "s") for name, v in _MULTIPLIERS.items()}

_PRECEDING_PREFIXERS = {"minus": "-", "negative": "-", "plus": "+",
                        "positive": "+"}
_FOLLOWING_PREFIXERS = {"pound": "£", "pounds": "£", "euro": "€",
                        "euros": "€", "dollar": "$", "dollars": "$",
                        "cent": "¢", "cents": "¢"}
_SUFFIXERS = {"percent": "%"}


class EnglishNumberNormalizer:
    """Convert spelled-out English numbers to digits.

    Handles the constructs that dominate speech transcripts: cardinal
    composition up to quintillions ("one hundred and twenty three" -> "123"),
    digit sequences ("one two three" -> "123", "nineteen sixty four" ->
    "1964"), tens+ones ("twenty one" -> "21"), ordinals ("twentieth" ->
    "20th"), plurals ("sixes" -> "6s"), decimals ("three point one four" ->
    "3.14"), currency words ("five dollars" -> "$5", "ten cents" -> "¢10",
    "$1 and ¢50" -> "$1.50"), percent, and minus/plus prefixes.
    """

    def __call__(self, s: str) -> str:
        # join hyphenated compounds ("twenty-one" -> "twenty one"), keep
        # apostrophe-s off number words ("1960's" handled post-hoc)
        s = re.sub(r"([a-z])-([a-z])", r"\1 \2", s)
        out = " ".join(self._process(s.split()))
        out = self._postprocess(out)
        return out

    # -- word-stream state machine ---------------------------------------
    def _process(self, words: List[str]) -> Iterator[str]:
        value: Optional[Union[int, str]] = None  # int, or str for sequences
        prefix: Optional[str] = None
        skip = False

        def finish(v, pre):
            if v is None:
                return None
            return (pre or "") + str(v)

        results: List[str] = []
        n = len(words)
        i = 0
        prev = None
        while i < n:
            word = words[i]
            nxt = words[i + 1] if i + 1 < n else None

            if word in _PRECEDING_PREFIXERS and value is None:
                # only a prefix if a number actually follows
                if nxt is not None and self._starts_number(nxt):
                    prefix = _PRECEDING_PREFIXERS[word]
                else:
                    results.append(word)
                i += 1
                continue

            if word in _ZEROS:
                value = (str(value) if value is not None else "") + "0"
            elif word in _ONES:
                v = _ONES[word]
                if value is None:
                    value = v
                elif isinstance(value, str):
                    if prev in _TENS and v < 10 and value.endswith("0"):
                        value = value[:-1] + str(v)  # "sixty four" -> 64
                    else:
                        value = str(value) + str(v)  # digit sequence
                elif v < 10:
                    if value % 10 == 0:
                        value += v  # twenty one -> 21, hundred five -> 105
                    else:
                        value = str(value) + str(v)
                else:  # teens
                    if value % 100 == 0:
                        value += v  # one hundred nineteen -> 119
                    else:
                        value = str(value) + str(v)
            elif word in _TENS:
                v = _TENS[word]
                if value is None:
                    value = v
                elif isinstance(value, str):
                    value = str(value) + str(v)
                elif value % 100 == 0:
                    value += v  # one hundred twenty
                else:
                    value = str(value) + str(v)  # nineteen sixty -> 1960
            elif word in _MULTIPLIERS:
                v = _MULTIPLIERS[word]
                if value is None:
                    value = v
                elif isinstance(value, str):
                    results.append(finish(value, prefix))
                    value, prefix = v, None
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    if v == 100:
                        value = before + residual * 100
                    elif residual != 0 and residual * v >= 1000:
                        value = before + residual * v
                    else:
                        value = value * v if value else v
            elif word in _ONES_ORDINAL or word in _TENS_ORDINAL \
                    or word in _MULT_ORDINAL or word in _ONES_PLURAL \
                    or word in _TENS_PLURAL or word in _MULT_PLURAL:
                v, suffix = (
                    _ONES_ORDINAL.get(word) or _TENS_ORDINAL.get(word)
                    or _MULT_ORDINAL.get(word) or _ONES_PLURAL.get(word)
                    or _TENS_PLURAL.get(word) or _MULT_PLURAL.get(word)
                )
                if value is None:
                    value = v
                elif isinstance(value, int) and value % 100 == 0 and v < 100:
                    value += v
                elif isinstance(value, int) and value % 10 == 0 and v < 10:
                    value += v
                else:
                    value = str(value) + str(v)
                results.append(finish(str(value) + suffix, prefix))
                value, prefix = None, None
            elif word == "point" and (value is not None or
                                      (nxt in _ONES or nxt in _ZEROS)):
                frac = []
                j = i + 1
                while j < n and (words[j] in _ONES or words[j] in _ZEROS):
                    frac.append("0" if words[j] in _ZEROS
                                else str(_ONES[words[j]]))
                    j += 1
                if frac:
                    value = str(value if value is not None else 0) + "." + \
                        "".join(frac)
                    prev = words[j - 1]
                    i = j
                    continue
                else:
                    if value is not None:
                        results.append(finish(value, prefix))
                        value, prefix = None, None
                    results.append(word)
            elif word in _FOLLOWING_PREFIXERS and value is not None:
                results.append(_FOLLOWING_PREFIXERS[word] + str(value))
                value, prefix = None, None
            elif word in _SUFFIXERS and value is not None:
                results.append(finish(str(value) + _SUFFIXERS[word], prefix))
                value, prefix = None, None
            elif word == "per" and nxt == "cent" and value is not None:
                results.append(finish(str(value) + "%", prefix))
                value, prefix = None, None
                i += 2
                continue
            elif word == "and" and value is not None and nxt is not None \
                    and self._starts_number(nxt):
                # "one hundred and five": skip the connective
                i += 1
                continue
            elif word == "double" and nxt is not None and \
                    (nxt in _ONES or nxt in _ZEROS):
                d = "0" if nxt in _ZEROS else str(_ONES[nxt])
                value = (str(value) if value is not None else "") + d + d
                prev = nxt
                i += 2
                continue
            elif word == "triple" and nxt is not None and \
                    (nxt in _ONES or nxt in _ZEROS):
                d = "0" if nxt in _ZEROS else str(_ONES[nxt])
                value = (str(value) if value is not None else "") + d * 3
                prev = nxt
                i += 2
                continue
            else:
                if value is not None:
                    results.append(finish(value, prefix))
                    value, prefix = None, None
                results.append(word)
            prev = word
            i += 1

        if value is not None:
            results.append(finish(value, prefix))
        return iter(r for r in results if r is not None)

    @staticmethod
    def _starts_number(word: str) -> bool:
        return (word in _ONES or word in _TENS or word in _MULTIPLIERS
                or word in _ZEROS or word in _ONES_ORDINAL
                or word in _TENS_ORDINAL or word in _ONES_PLURAL
                or word in _TENS_PLURAL or word in ("double", "triple"))

    @staticmethod
    def _postprocess(s: str) -> str:
        # "$1 and ¢50" -> "$1.50" (dollars-and-cents combination)
        def combine(m: re.Match) -> str:
            currency, whole, cents = m.group(1), m.group(2), int(m.group(3))
            return f"{currency}{whole}.{cents:02d}"

        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine, s)
        # "¢1" -> "1 cent" styling is upstream's "one cent" special case;
        # keep symbols, they are stripped consistently later if non-numeric
        return s


# ----------------------------------------------------------------------------
# Spelling (British -> American), high-frequency head of the upstream list
# ----------------------------------------------------------------------------

_SPELLING: Dict[str, str] = {
    # -our -> -or
    "colour": "color", "colours": "colors", "coloured": "colored",
    "colourful": "colorful", "favour": "favor", "favours": "favors",
    "favourite": "favorite", "favourites": "favorites",
    "flavour": "flavor", "flavours": "flavors", "honour": "honor",
    "honours": "honors", "honourable": "honorable", "humour": "humor",
    "labour": "labor", "labours": "labors", "neighbour": "neighbor",
    "neighbours": "neighbors", "neighbourhood": "neighborhood",
    "rumour": "rumor", "rumours": "rumors", "saviour": "savior",
    "behaviour": "behavior", "behaviours": "behaviors",
    "endeavour": "endeavor", "endeavours": "endeavors",
    "harbour": "harbor", "harbours": "harbors", "armour": "armor",
    "odour": "odor", "vapour": "vapor", "vigour": "vigor",
    "splendour": "splendor", "ardour": "ardor", "candour": "candor",
    "clamour": "clamor", "demeanour": "demeanor", "fervour": "fervor",
    "parlour": "parlor", "rancour": "rancor", "valour": "valor",
    # -re -> -er
    "centre": "center", "centres": "centers", "theatre": "theater",
    "theatres": "theaters", "metre": "meter", "metres": "meters",
    "litre": "liter", "litres": "liters", "fibre": "fiber",
    "fibres": "fibers", "calibre": "caliber", "sombre": "somber",
    "lustre": "luster", "sceptre": "scepter", "spectre": "specter",
    "mitre": "miter", "nitre": "niter", "sabre": "saber",
    "manoeuvre": "maneuver", "manoeuvres": "maneuvers",
    # -ise/-yse -> -ize/-yze
    "organise": "organize", "organised": "organized",
    "organises": "organizes", "organising": "organizing",
    "organisation": "organization", "organisations": "organizations",
    "recognise": "recognize", "recognised": "recognized",
    "recognises": "recognizes", "recognising": "recognizing",
    "realise": "realize", "realised": "realized", "realises": "realizes",
    "realising": "realizing", "realisation": "realization",
    "apologise": "apologize", "apologised": "apologized",
    "criticise": "criticize", "criticised": "criticized",
    "emphasise": "emphasize", "emphasised": "emphasized",
    "specialise": "specialize", "specialised": "specialized",
    "civilisation": "civilization", "civilised": "civilized",
    "analyse": "analyze", "analysed": "analyzed", "analysing": "analyzing",
    "paralyse": "paralyze", "paralysed": "paralyzed",
    # -ce/-se pairs
    "defence": "defense", "defences": "defenses", "offence": "offense",
    "offences": "offenses", "licence": "license", "licences": "licenses",
    "pretence": "pretense", "practise": "practice",
    "practised": "practiced", "practising": "practicing",
    # -ll- vs -l-
    "travelled": "traveled", "travelling": "traveling",
    "traveller": "traveler", "travellers": "travelers",
    "cancelled": "canceled", "cancelling": "canceling",
    "labelled": "labeled", "labelling": "labeling",
    "levelled": "leveled", "levelling": "leveling",
    "marvelled": "marveled", "marvellous": "marvelous",
    "modelled": "modeled", "modelling": "modeling",
    "quarrelled": "quarreled", "quarrelling": "quarreling",
    "signalled": "signaled", "signalling": "signaling",
    "jewellery": "jewelry", "woollen": "woolen", "counsellor": "counselor",
    # ae/oe simplification
    "anaemia": "anemia", "anaesthesia": "anesthesia",
    "archaeology": "archeology", "encyclopaedia": "encyclopedia",
    "mediaeval": "medieval", "manoeuvred": "maneuvered",
    "foetus": "fetus", "oesophagus": "esophagus", "oestrogen": "estrogen",
    # misc high-frequency
    "grey": "gray", "greyish": "grayish", "tyre": "tire", "tyres": "tires",
    "kerb": "curb", "plough": "plow", "ploughed": "plowed",
    "cheque": "check", "cheques": "checks", "gaol": "jail",
    "draught": "draft", "draughts": "drafts", "pyjamas": "pajamas",
    "programme": "program", "programmes": "programs",
    "aeroplane": "airplane", "aeroplanes": "airplanes",
    "aluminium": "aluminum", "moustache": "mustache",
    "sceptical": "skeptical", "scepticism": "skepticism",
    "storey": "story", "storeys": "stories", "whisky": "whiskey",
    "mould": "mold", "moulded": "molded", "smoulder": "smolder",
    "smouldering": "smoldering", "sulphur": "sulfur",
    "catalogue": "catalog", "catalogues": "catalogs",
    "dialogue": "dialog", "dialogues": "dialogs",
    "axe": "ax", "annexe": "annex", "artefact": "artifact",
    "enquire": "inquire", "enquired": "inquired", "enquiry": "inquiry",
    "enquiries": "inquiries", "fulfil": "fulfill", "fulfilment":
    "fulfillment", "instalment": "installment", "skilful": "skillful",
    "wilful": "willful", "enrol": "enroll", "enrolment": "enrollment",
    "distil": "distill", "instil": "instill", "appal": "appall",
    "carburettor": "carburetor", "connexion": "connection",
    "despatch": "dispatch", "gramme": "gram", "grammes": "grams",
    "kilogramme": "kilogram", "kilometre": "kilometer",
    "kilometres": "kilometers", "millimetre": "millimeter",
    "centimetre": "centimeter", "centimetres": "centimeters",
    "speciality": "specialty", "towards": "toward", "afterwards":
    "afterward", "forwards": "forward", "backwards": "backward",
}


class EnglishSpellingNormalizer:
    def __init__(self, extra: Optional[Dict[str, str]] = None):
        self.mapping = dict(_SPELLING)
        if extra:
            self.mapping.update(extra)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in s.split())


# ----------------------------------------------------------------------------
# Full pipeline
# ----------------------------------------------------------------------------

_IGNORE_PATTERNS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"

_REPLACERS = {
    # common contractions
    r"\bwon't\b": "will not",
    r"\bcan't\b": "can not",
    r"\blet's\b": "let us",
    r"\bain't\b": "aint",
    r"\by'all\b": "you all",
    r"\bwanna\b": "want to",
    r"\bgotta\b": "got to",
    r"\bgonna\b": "going to",
    r"\bi'ma\b": "i am going to",
    r"\bimma\b": "i am going to",
    r"\bwoulda\b": "would have",
    r"\bcoulda\b": "could have",
    r"\bshoulda\b": "should have",
    r"\bma'am\b": "madam",
    # title abbreviations
    r"\bmr\b": "mister ",
    r"\bmrs\b": "missus ",
    r"\bst\b": "saint ",
    r"\bdr\b": "doctor ",
    r"\bprof\b": "professor ",
    r"\bcapt\b": "captain ",
    r"\bgov\b": "governor ",
    r"\bald\b": "alderman ",
    r"\bgen\b": "general ",
    r"\bsen\b": "senator ",
    r"\brep\b": "representative ",
    r"\bpres\b": "president ",
    r"\brev\b": "reverend ",
    r"\bhon\b": "honorable ",
    r"\basst\b": "assistant ",
    r"\bassoc\b": "associate ",
    r"\blt\b": "lieutenant ",
    r"\bcol\b": "colonel ",
    r"\bjr\b": "junior ",
    r"\bsr\b": "senior ",
    r"\besq\b": "esquire ",
    # suffix contractions
    r"'d been\b": " had been",
    r"'s been\b": " has been",
    r"'d gone\b": " had gone",
    r"'s gone\b": " has gone",
    r"'d done\b": " had done",
    r"'s got\b": " has got",
    r"n't\b": " not",
    r"'re\b": " are",
    r"'s\b": " is",
    r"'d\b": " would",
    r"'ll\b": " will",
    r"'t\b": " not",
    r"'ve\b": " have",
    r"'m\b": " am",
}


class EnglishTextNormalizer:
    def __init__(self):
        self.number = EnglishNumberNormalizer()
        self.spelling = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # bracketed asides
        s = re.sub(r"\(([^)]+?)\)", "", s)  # parenthesized asides
        s = re.sub(_IGNORE_PATTERNS, "", s)
        s = re.sub(r"\s+'", "'", s)  # "they 're" -> "they're"
        for pattern, replacement in _REPLACERS.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # 1,000 -> 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # keep decimal points only
        # strip punctuation BEFORE number words are parsed ("dollars," must
        # reach the number normalizer as a bare word)
        s = re.sub(r"[^\w\s.%$¢€£-]", " ", s)
        s = self.number(s)
        s = self.spelling(s)
        # drop currency/percent symbols not attached to a number
        s = re.sub(r"[.$¢€£](?=[^0-9]|$)", " ", s)
        s = re.sub(r"(?<![0-9])%", " ", s)
        s = re.sub(r"\s+", " ", s)
        return s.strip()
