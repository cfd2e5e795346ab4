"""Docstring templating (counterpart of keras_rs_tpu/utils/doc_utils.py):
fills `{placeholders}` in a docstring template and re-wraps prose
paragraphs to a width, leaving code blocks as they are."""

from __future__ import annotations

import textwrap


def format_docstring(template: str, width: int = 80, **kwargs: str) -> str:
    """Substitutes placeholders and wraps prose paragraphs.

    Lines inside triple-backtick code fences and indented blocks are left
    untouched.
    """
    filled = template.format(**kwargs)
    out_lines: list[str] = []
    in_code = False
    paragraph: list[str] = []

    def flush() -> None:
        if paragraph:
            wrapped = textwrap.fill(" ".join(paragraph), width=width)
            out_lines.extend(wrapped.split("\n"))
            paragraph.clear()

    for line in filled.split("\n"):
        stripped = line.strip()
        if stripped.startswith("```"):
            flush()
            in_code = not in_code
            out_lines.append(line)
        elif in_code or line.startswith(("    ", "\t")) or not stripped:
            flush()
            out_lines.append(line)
        else:
            paragraph.append(stripped)
    flush()
    return "\n".join(out_lines)
