"""VQA answer normalization + accuracy metrics: the port's own copy of
``dynamic_llava_tpu/eval/vqa_metrics.py``.

Compact reimplementation of the EvalAI answer processor and VQA-accuracy
metric used by the reference scorers (the reference's
``llava/dynamic_eval/m4c_evaluator.py``): contraction fixing, punctuation
stripping, article removal, digit-word mapping, and the min(#matches/3, 1)
VQA accuracy over 10 reference answers. The word tables are shared VQA-eval
data.
"""

from __future__ import annotations

import re
from typing import Dict, List

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_DIGIT_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = {"a", "an", "the"}

_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]

_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")


class VQAAnswerProcessor:
    """EvalAI-compatible answer normalization."""

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, text: str) -> str:
        out = text
        for p in _PUNCT:
            if (p + " " in text or " " + p in text) or (
                re.search(_COMMA_STRIP, text) is not None
            ):
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        out = _PERIOD_STRIP.sub("", out, re.UNICODE)
        return out

    def process_digit_article(self, text: str) -> str:
        out = []
        for word in text.lower().split():
            word = _DIGIT_WORDS.get(word, word)
            if word not in _ARTICLES:
                out.append(word)
        for i, word in enumerate(out):
            if word in _CONTRACTIONS:
                out[i] = _CONTRACTIONS[word]
        return " ".join(out)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


class TextVQAAccuracyEvaluator:
    """min(#matching human answers / 3, 1), averaged — with the
    leave-one-annotator-out protocol of the official VQA metric."""

    def __init__(self):
        self.processor = VQAAnswerProcessor()

    def _compute_answer_scores(self, raw_answers: List[str]) -> Dict[str, float]:
        answers = [self.processor(a) for a in raw_answers]
        assert len(answers) == 10
        scores: Dict[str, float] = {}
        for answer in set(answers):
            accs = []
            for i in range(len(answers)):
                other = answers[:i] + answers[i + 1 :]
                accs.append(min(1.0, other.count(answer) / 3.0))
            scores[answer] = sum(accs) / len(accs)
        return scores

    def eval_pred_list(self, pred_list: List[dict]) -> float:
        scores = []
        for entry in pred_list:
            pred = self.processor(entry["pred_answer"])
            gt_scores = self._compute_answer_scores(entry["gt_answers"])
            scores.append(gt_scores.get(pred, 0.0))
        return sum(scores) / len(scores) if scores else 0.0


class STVQAAccuracyEvaluator:
    """Exact-match accuracy after normalization (ST-VQA protocol)."""

    def __init__(self):
        self.processor = VQAAnswerProcessor()

    def eval_pred_list(self, pred_list: List[dict]) -> float:
        scores = []
        for entry in pred_list:
            pred = self.processor(entry["pred_answer"])
            gts = [self.processor(a) for a in entry["gt_answers"]]
            scores.append(1.0 if pred in gts else 0.0)
        return sum(scores) / len(scores) if scores else 0.0
