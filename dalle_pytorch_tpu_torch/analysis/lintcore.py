"""Shared linter core of the port's racelint.

Port of ``dalle_pytorch_tpu/analysis/lintcore.py``: the finding schema
(``{rule, slug, path, line, col, message}``), its JSON form, the ONE
in-line waiver parser, ``iter_py_files`` and ``DEFAULT_EXCLUDES``. A
waiver reads

    # racelint: disable=RULE — reason why this one is fine

scoped to the offending line (or the comment line above it); the slug
form (``disable=blocking-under-lock``) and ``disable=all`` work too. The
tool name stays ``racelint``, so one waiver satisfies the JAX package's
linter and this one alike, and ``jaxlint`` waivers stay inert here.

Only racelint registers rules in the slug registry (rule ids are
namespaced, ``RL...``), which lets ``Finding`` stay a plain frozen
dataclass constructed positionally while still rendering its slug.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, List, Sequence, Set, Tuple

# rule id -> slug, fed by racelint's register_rules at import time.
_SLUGS: Dict[str, str] = {}

# the linters' true-positive corpora under tests/fixtures/ must not fail
# a gate over tests/: racelint's own corpus, and the JAX package's jaxlint
# corpus, whose fixtures also break racelint's rules.
DEFAULT_EXCLUDES = ("fixtures/jaxlint", "fixtures/racelint")


def register_rules(rules: Dict[str, Tuple[str, str]]) -> None:
    """Register ``{rule_id: (slug, description)}`` so ``Finding.slug``
    resolves. racelint calls this at import."""
    for rid, (slug, _desc) in rules.items():
        _SLUGS[rid] = slug


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    @property
    def slug(self) -> str:
        return _SLUGS.get(self.rule, self.rule.lower())

    def to_dict(self) -> dict:
        return {"rule": self.rule, "slug": self.slug, "path": self.path,
                "line": self.line, "col": self.col,
                "message": self.message}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"({self.slug}) {self.message}")


def suppressions(src: str, tool: str,
                 rules: Dict[str, Tuple[str, str]]) -> Dict[int, Set[str]]:
    """line -> set of suppressed rule ids for ``tool`` (``racelint``; a
    comment naming another tool is inert). A trailing comment
    suppresses its own line; a comment-only line also suppresses the
    next code line (for statements too long to share a line with their
    waiver)."""
    disable_re = re.compile(
        rf"{re.escape(tool)}:\s*disable=([A-Za-z0-9_,\-]+)")
    slug_to_id = {slug: rid for rid, (slug, _) in rules.items()}
    out: Dict[int, Set[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except tokenize.TokenizeError:
        return out
    code_lines = set()
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            m = disable_re.search(tok.string)
            if not m:
                continue
            found: Set[str] = set()
            for part in m.group(1).split(","):
                part = part.strip()
                if part.lower() == "all":
                    found |= set(rules)
                elif part.upper() in rules:
                    found.add(part.upper())
                elif part in slug_to_id:
                    found.add(slug_to_id[part])
            out.setdefault(tok.start[0], set()).update(found)
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                              tokenize.INDENT, tokenize.DEDENT,
                              tokenize.ENCODING, tokenize.ENDMARKER):
            code_lines.add(tok.start[0])
    max_line = max(code_lines, default=0)
    for line in list(out):
        if line in code_lines:
            continue
        # standalone waiver: skip the rest of its comment block and
        # cover the first code line after it
        nxt = line + 1
        while nxt <= max_line and nxt not in code_lines:
            nxt += 1
        out.setdefault(nxt, set()).update(out[line])
    return out


def filter_findings(findings: List[Finding], src: str, tool: str,
                    rules: Dict[str, Tuple[str, str]]) -> List[Finding]:
    """Apply the suppression comments, sort, and dedupe (two rules can
    hit one call site; keep the first per (line, col, rule))."""
    supp = suppressions(src, tool, rules)
    findings = [f for f in findings
                if f.rule not in supp.get(f.line, set())]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    seen: Set[Tuple] = set()
    out = []
    for f in findings:
        k = (f.line, f.col, f.rule)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def iter_py_files(paths: Sequence[str],
                  excludes: Sequence[str] = DEFAULT_EXCLUDES
                  ) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            out.extend(sorted(pp.rglob("*.py")))
        elif pp.suffix == ".py":
            out.append(pp)
    return [p for p in out
            if not any(ex in str(p) for ex in excludes)
            and "__pycache__" not in str(p)]


def dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for a Name/Attribute chain, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def last(node: ast.AST) -> str:
    """Final component of a Name/Attribute chain ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def mod_parts(path: str) -> Tuple[str, ...]:
    """Dotted-module parts of a file path ('.../serve/engine.py' ->
    (..., 'serve', 'engine')); a package's __init__.py is the package
    itself."""
    p = Path(path)
    parts = list(p.parts)
    parts[-1] = p.stem
    if parts[-1] == "__init__":
        parts.pop()
    return tuple(parts)
