"""ScienceQA base-prompt builders (QCM→A / QCM→ALE / few-shot variants),
the reference's ``scripts/convert_sqa_to_llava_base_prompt.py`` with the
formats as data (an input-segment walk and an output-template table) and
its byte-level output kept, the 'AL' / 'AE' swap included: an own copy of ``dynamic_llava_tpu/eval/convert_sqa_to_llava_base_prompt.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_config.py`` holds the two
equal)."""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

DEFAULT_OPTIONS = ("A", "B", "C", "D", "E")

# Output templates, keyed by output_format. {answer}/{lecture}/{solution}
# are substituted; note AL/AE intentionally mirror the reference's swap.
OUTPUT_TEMPLATES = {
    "A": "Answer: The answer is {answer}.",
    "AL": "Answer: The answer is {answer}. BECAUSE: {solution}",
    "AE": "Answer: The answer is {answer}. BECAUSE: {lecture}",
    "ALE": "Answer: The answer is {answer}. BECAUSE: {lecture} {solution}",
    "AEL": "Answer: The answer is {answer}. BECAUSE: {solution} {lecture}",
    "LA": "Answer: {lecture} The answer is {answer}.",
    "EA": "Answer: {solution} The answer is {answer}.",
    "LEA": "Answer: {lecture} {solution} The answer is {answer}.",
    "ELA": "Answer: {solution} {lecture} The answer is {answer}.",
}


def get_question_text(problem) -> str:
    return problem["question"]


def get_context_text(problem, use_caption: bool) -> str:
    txt_context = problem["hint"]
    img_context = problem["caption"] if use_caption else ""
    context = " ".join([txt_context, img_context]).strip()
    return context if context else "N/A"


def get_choice_text(problem, options=DEFAULT_OPTIONS) -> str:
    return " ".join(f"({options[i]}) {c}"
                    for i, c in enumerate(problem["choices"]))


def get_answer(problem, options=DEFAULT_OPTIONS) -> str:
    return options[problem["answer"]]


def get_lecture_text(problem) -> str:
    # \\n lets a text-davinci-style model emit longer continuations
    return problem["lecture"].replace("\n", "\\n")


def get_solution_text(problem) -> str:
    return problem["solution"].replace("\n", "\\n")


def _render_input(input_format: str, question: str, context: str,
                  choice: str, lecture: str, solution: str) -> str:
    """Walk the format string: Q/C/M are one line each; a contiguous run of
    L/E becomes a single 'BECAUSE:' line holding those texts in order."""
    lines: List[str] = []
    because: List[str] = []

    def flush_because():
        if because:
            lines.append("BECAUSE: " + " ".join(because))
            because.clear()

    for ch in input_format:
        if ch in "LE":
            because.append(lecture if ch == "L" else solution)
            continue
        flush_because()
        if ch == "Q":
            lines.append(f"Question: {question}")
        elif ch == "C":
            lines.append(f"Context: {context}")
        elif ch == "M":
            lines.append(f"Options: {choice}")
        else:
            raise ValueError(f"unknown input segment {ch!r}")
    flush_because()
    return "\n".join(lines) + "\n"


def _render_output(output_format: str, answer: str, lecture: str,
                   solution: str, test_example: bool) -> str:
    if test_example:
        return "Answer:"
    if output_format == "LEPA":
        out = ""
        if lecture.strip():
            out += f"LECTURE: {lecture}\n"
        if solution.strip():
            out += f"SOLUTION: {solution}\n"
        return out + "###\n" + f"ANSWER: {answer}."
    return OUTPUT_TEMPLATES[output_format].format(
        answer=answer, lecture=lecture, solution=solution)


def _squeeze(text: str) -> str:
    return text.replace("  ", " ").strip()


def _drop_empty_because(text: str) -> str:
    if text.endswith("BECAUSE:"):
        text = text.replace("BECAUSE:", "").strip()
    return text


def _tidy(text: str) -> str:
    return _drop_empty_because(_squeeze(text))


def render_pair(prompt_format: str, question: str, context: str,
                choice: str, answer: str, lecture: str, solution: str,
                test_example: bool = True) -> Tuple[str, str]:
    """Render one raw (input, output) pair for a 'IN-OUT' format string.
    The input keeps its trailing newline; tidying is packaging-specific."""
    input_format, output_format = prompt_format.split("-")
    rendered_in = _render_input(input_format, question, context, choice,
                                lecture, solution)
    rendered_out = _render_output(output_format, answer, lecture, solution,
                                  test_example)
    return rendered_in, rendered_out


def format_example(prompt_format: str, question: str, context: str,
                   choice: str, answer: str, lecture: str, solution: str,
                   test_example: bool = True) -> Tuple[str, str]:
    """Chatbot packaging: both sides squeezed + empty-BECAUSE-stripped."""
    inp, out = render_pair(prompt_format, question, context, choice, answer,
                           lecture, solution, test_example)
    return _tidy(inp), _tidy(out)


def format_example_plain(prompt_format: str, question: str, context: str,
                         choice: str, answer: str, lecture: str,
                         solution: str, test_example: bool = True) -> str:
    """Plain packaging: concatenate raw input+output, tidy the whole text
    (preserves the newline before 'Answer:' in test stubs)."""
    inp, out = render_pair(prompt_format, question, context, choice, answer,
                           lecture, solution, test_example)
    return _tidy(inp + out)


def format_example_gpt4(prompt_format: str, question: str, context: str,
                        choice: str, answer: str, lecture: str,
                        solution: str,
                        test_example: bool = True) -> Tuple[str, str]:
    """GPT-4 chat packaging: squeeze both; empty-BECAUSE strip on the
    output only (matching the reference's create_one_example_gpt4)."""
    inp, out = render_pair(prompt_format, question, context, choice, answer,
                           lecture, solution, test_example)
    return _squeeze(inp), _drop_empty_because(_squeeze(out))


def _problem_fields(problem, use_caption: bool, options,
                    unescape_newlines: bool = False):
    lecture = get_lecture_text(problem)
    solution = get_solution_text(problem)
    if unescape_newlines:
        lecture = lecture.replace("\\n", "\n")
        solution = solution.replace("\\n", "\n")
    return dict(
        question=get_question_text(problem),
        context=get_context_text(problem, use_caption),
        choice=get_choice_text(problem, options),
        answer=get_answer(problem, options),
        lecture=lecture,
        solution=solution,
    )


def build_prompt_chatbot(problems, shot_qids, prompt_format,
                         use_caption: bool = False,
                         options=DEFAULT_OPTIONS,
                         is_test: bool = False) -> Dict:
    """Per-problem (input, output) tuples for chatbot-style training data."""
    return {
        qid: format_example(
            prompt_format,
            **_problem_fields(problems[qid], use_caption, options,
                              unescape_newlines=True),
            test_example=is_test,
        )
        for qid in shot_qids
    }


def build_prompt(problems, shot_qids, test_qid, args) -> str:
    """Few-shot plain-text prompt: N solved examples + the test stub."""
    examples = [
        format_example_plain(
            args.prompt_format,
            **_problem_fields(problems[qid], args.use_caption, args.options),
            test_example=False)
        for qid in shot_qids
    ]
    examples.append(format_example_plain(
        args.prompt_format,
        **_problem_fields(problems[test_qid], args.use_caption, args.options),
        test_example=True))
    return "\n\n".join(examples)


def build_prompt_gpt4(problems, shot_qids, test_qid, args) -> List[Dict]:
    """Few-shot chat-message prompt for a GPT-4-style judge/answerer."""
    messages = [{"role": "system", "content": "You are a helpful assistant."}]
    for qid, is_test in [(q, False) for q in shot_qids] + [(test_qid, True)]:
        inp, out = format_example_gpt4(
            args.prompt_format,
            **_problem_fields(problems[qid], args.use_caption, args.options),
            test_example=is_test)
        messages.append({"role": "user", "content": f"Can you explain {inp}?"})
        messages.append({"role": "assistant", "content": out})
    return messages
