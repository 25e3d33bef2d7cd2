"""Build the static review-comparison webpage from Q/A/review tables (the
reference's ``llava/eval/generate_webpage_data_from_table.py``: data.json
and one self-contained index.html viewer): an own copy of ``dynamic_llava_tpu/eval/generate_webpage_data.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List


def read_jsonl(path: str, key: str = None):
    with open(os.path.expanduser(path)) as f:
        data = [json.loads(line) for line in f if line.strip()]
    if key is not None:
        data.sort(key=lambda x: x[key])
        return {item[key]: item for item in data}
    return data


def clean_review(text: str) -> str:
    """Drop a leading 'x y' score pair and bold the assistant labels
    (reference :84-94)."""
    lines = text.strip().split("\n")
    if lines and re.match(r"\d+[, ]+\d+", lines[0]):
        lines = lines[1:]
    cleaned = "\n".join(lines)
    return cleaned.replace("Assistant 1", "**Assistant 1**").replace(
        "Assistant 2", "**Assistant 2**")


def build_records(question_file: str, baseline_answers: str,
                  our_answers: str, review_file: str,
                  baseline_name: str = "baseline") -> List[Dict]:
    questions = read_jsonl(question_file, key="question_id")
    base = read_jsonl(baseline_answers, key="question_id")
    ours = read_jsonl(our_answers, key="question_id")
    reviews = read_jsonl(review_file, key="question_id")

    records = []
    for qid, q in questions.items():
        review = reviews[qid]
        records.append({
            "id": qid,
            "category": q["category"],
            "question": q["text"],
            "answers": {baseline_name: base[qid]["text"],
                        "ours": ours[qid]["text"]},
            "evaluations": {baseline_name: clean_review(review["content"])},
            "scores": {baseline_name: review["tuple"]},
        })
    records.sort(key=lambda r: r["id"])
    return records


_VIEWER_TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Pairwise review browser</title>
<style>
 body {{ font-family: system-ui, sans-serif; max-width: 60rem;
        margin: 2rem auto; padding: 0 1rem; line-height: 1.5; }}
 .card {{ border: 1px solid #ccc; border-radius: 8px;
         padding: 1rem; margin: 1rem 0; }}
 .score {{ font-weight: 600; }}
 .answer {{ background: #f6f6f6; border-radius: 6px;
           padding: .5rem .75rem; white-space: pre-wrap; }}
 h3 {{ margin: .75rem 0 .25rem; }}
 .cat {{ color: #666; font-size: .85rem; }}
</style>
</head>
<body>
<h1>Pairwise review browser</h1>
<div id="root">Loading data.json…</div>
<script>
fetch('data.json').then(r => r.json()).then(data => {{
  const root = document.getElementById('root');
  root.textContent = '';
  for (const q of data.questions) {{
    const card = document.createElement('div');
    card.className = 'card';
    let inner = `<div class="cat">#${{q.id}} · ${{q.category}}</div>` +
                `<h3>Q: ${{esc(q.question)}}</h3>`;
    for (const [name, text] of Object.entries(q.answers))
      inner += `<h3>${{esc(name)}}</h3><div class="answer">${{esc(text)}}</div>`;
    for (const [name, scores] of Object.entries(q.scores))
      inner += `<p class="score">judge scores (${{esc(name)}} vs ours): ` +
               `${{scores[0]}} / ${{scores[1]}}</p>`;
    for (const text of Object.values(q.evaluations))
      inner += `<div class="answer">${{esc(text)}}</div>`;
    card.innerHTML = inner;
    root.appendChild(card);
  }}
}});
function esc(s) {{
  const d = document.createElement('span');
  d.textContent = s == null ? '' : String(s);
  return d.innerHTML;
}}
</script>
</body>
</html>
"""


def write_webpage(records: List[Dict], models: List[str],
                  output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "data.json"), "w") as f:
        json.dump({"questions": records, "models": models}, f, indent=2)
    with open(os.path.join(output_dir, "index.html"), "w") as f:
        f.write(_VIEWER_TEMPLATE.format())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--question-file", required=True)
    parser.add_argument("--baseline-answers", required=True)
    parser.add_argument("--our-answers", required=True)
    parser.add_argument("--review-file", required=True)
    parser.add_argument("--baseline-name", default="baseline")
    parser.add_argument("--output-dir", default="webpage")
    args = parser.parse_args(argv)
    records = build_records(args.question_file, args.baseline_answers,
                            args.our_answers, args.review_file,
                            args.baseline_name)
    write_webpage(records, [args.baseline_name], args.output_dir)


if __name__ == "__main__":
    main()
