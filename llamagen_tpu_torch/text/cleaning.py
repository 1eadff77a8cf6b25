"""Caption cleaning for t2i conditioning.

The port's own copy of `llamagen_tpu/text/cleaning.py` (JAX-free): the
steps of upstream LlamaGen's PixArt-derived pipeline (`language/t5.py`),
in the same order, so cleaned captions match the training-time
distribution of the released t2i checkpoints. ftfy and bs4 are optional;
without ftfy, mojibake fixing is skipped.
"""

from __future__ import annotations

import html
import re
import urllib.parse as ul

try:
    import ftfy
    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

try:
    from bs4 import BeautifulSoup
    _HAS_BS4 = True
except ImportError:
    _HAS_BS4 = False

_BAD_PUNCT = re.compile(r"[#®•©™&@·º½¾¿¡§~\)\(\]\[\}\{\|\\/\*]{1,}")
_URL1 = re.compile(
    r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.]"
    r"(?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))")
_URL2 = re.compile(
    r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.]"
    r"(?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))")
_CJK_RANGES = [r"[\u31c0-\u31ef]+", r"[\u31f0-\u31ff]+", r"[\u3200-\u32ff]+",
               r"[\u3300-\u33ff]+", r"[\u3400-\u4dbf]+", r"[\u4dc0-\u4dff]+",
               r"[\u4e00-\u9fff]+"]
_DASHES = (r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A"
           r"\u2E3B\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+")
_HYPHEN_UNDERSCORE = re.compile(r"(?:\-|\_)")


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def clean_caption(caption: str) -> str:
    caption = str(caption)
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    caption = re.sub("<person>", "person", caption)
    caption = _URL1.sub("", caption)
    caption = _URL2.sub("", caption)
    if _HAS_BS4:
        caption = BeautifulSoup(caption, features="html.parser").text
    caption = re.sub(r"@[\w\d]+\b", "", caption)
    for rng in _CJK_RANGES:
        caption = re.sub(rng, "", caption)
    caption = re.sub(_DASHES, "-", caption)
    caption = re.sub(r"[`´«»“”¨]", '"', caption)
    caption = re.sub(r"[‘’]", "'", caption)
    caption = re.sub(r"&quot;?", "", caption)
    caption = re.sub(r"&amp", "", caption)
    caption = re.sub(r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}", " ", caption)
    caption = re.sub(r"\d:\d\d\s+$", "", caption)
    caption = re.sub(r"\\n", " ", caption)
    caption = re.sub(r"#\d{1,3}\b", "", caption)
    caption = re.sub(r"#\d{5,}\b", "", caption)
    caption = re.sub(r"\b\d{6,}\b", "", caption)
    caption = re.sub(r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)",
                     "", caption)
    caption = re.sub(r"[\"\']{2,}", r'"', caption)
    caption = re.sub(r"[\.]{2,}", r" ", caption)
    caption = re.sub(_BAD_PUNCT, r" ", caption)
    caption = re.sub(r"\s+\.\s+", r" ", caption)
    if len(re.findall(_HYPHEN_UNDERSCORE, caption)) > 3:
        caption = re.sub(_HYPHEN_UNDERSCORE, " ", caption)
    caption = basic_clean(caption)
    caption = re.sub(r"\b[a-zA-Z]{1,3}\d{3,15}\b", "", caption)
    caption = re.sub(r"\b[a-zA-Z]+\d+[a-zA-Z]+\b", "", caption)
    caption = re.sub(r"\b\d+[a-zA-Z]+\d+\b", "", caption)
    caption = re.sub(r"(worldwide\s+)?(free\s+)?shipping", "", caption)
    caption = re.sub(r"(free\s)?download(\sfree)?", "", caption)
    caption = re.sub(r"\bclick\b\s(?:for|on)\s\w+", "", caption)
    caption = re.sub(r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)"
                     r"(\simage[s]?)?", "", caption)
    caption = re.sub(r"\bpage\s+\d+\b", "", caption)
    caption = re.sub(r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", r" ",
                     caption)
    caption = re.sub(r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", "", caption)
    caption = re.sub(r"\b\s+\:\s+", r": ", caption)
    caption = re.sub(r"(\D[,\./])\b", r"\1 ", caption)
    caption = re.sub(r"\s+", " ", caption)
    caption.strip()
    caption = re.sub(r"^[\"\']([\w\W]+)[\"\']$", r"\1", caption)
    caption = re.sub(r"^[\'\_,\-\:;]", r"", caption)
    caption = re.sub(r"[\'\_,\-\:\-\+]$", r"", caption)
    caption = re.sub(r"^\.\S+$", "", caption)
    return caption.strip()


def text_preprocessing(text: str, enabled: bool = True) -> str:
    """Cleaning applied twice, as at t2i training time (ref: t5.py:81-88)."""
    if enabled:
        return clean_caption(clean_caption(text))
    return text.lower().strip()
