"""GPT-3.5 baseline answers for the pairwise-review pipeline: the port's own
copy of ``dynamic_llava_tpu/eval/qa_baseline_gpt35.py``.

The client is any callable from question to answer text, so the pipeline
runs offline; the default, ``openai_answerer``, needs the ``openai``
package, the network and ``OPENAI_API_KEY``, and imports ``openai`` only
when it is called.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import time
import uuid
from typing import Callable, Dict, Optional

MODEL = "gpt-3.5-turbo"
MODEL_ID = "gpt-3.5-turbo:20230327"
RETRIES = 3


def openai_answerer(model: str = MODEL, max_tokens: int = 1024) -> Callable:
    import openai

    def answer(question: str) -> str:
        for _ in range(RETRIES):
            try:
                response = openai.chat.completions.create(
                    model=model,
                    messages=[
                        {"role": "system",
                         "content": "You are a helpful assistant."},
                        {"role": "user", "content": question},
                    ],
                    max_tokens=max_tokens,
                )
                return response.choices[0].message.content
            except Exception as e:
                print("[ERROR]", e)
                time.sleep(1)
        return "#ERROR#"

    return answer


def generate_answers(
    question_file: str,
    output_file: str,
    client: Optional[Callable] = None,
    max_tokens: int = 1024,
    workers: int = 32,
) -> None:
    client = client or openai_answerer(max_tokens=max_tokens)
    questions: Dict = {}
    with open(os.path.expanduser(question_file)) as f:
        for line in f:
            if line.strip():
                q = json.loads(line)
                questions[q["question_id"]] = q["text"]

    def run_one(qid) -> Dict:
        return {
            "answer_id": uuid.uuid4().hex,
            "question_id": qid,
            "model_id": MODEL_ID,
            "text": client(questions[qid]),
        }

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        answers = list(pool.map(run_one, questions))
    answers.sort(key=lambda a: a["question_id"])

    with open(os.path.expanduser(output_file), "w") as f:
        f.write("\n".join(json.dumps(a) for a in answers))


def main(argv=None):
    parser = argparse.ArgumentParser(description="ChatGPT answer generation.")
    parser.add_argument("-q", "--question", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--max-tokens", type=int, default=1024)
    args = parser.parse_args(argv)
    generate_answers(args.question, args.output, max_tokens=args.max_tokens)


if __name__ == "__main__":
    main()
