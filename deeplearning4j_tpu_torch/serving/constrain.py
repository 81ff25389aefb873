"""Grammar-constrained decoding: token-DFA masks as runtime data.

The port's copy of deeplearning4j_tpu/serving/constrain.py (the port
imports nothing of the JAX package): the caller declares a regex (or a
JSON-schema subset, lowered to a regex), this module compiles it once
into a token-level DFA over the model vocabulary, and the engine
threads a per-slot int32 DFA state through the masked slot programs
(`parallel.serving`, ``constrain=True``). The compiled artifacts are
pure runtime data:

- ``CompiledGrammar`` — a dense ``[num_states, V]`` bool allow mask +
  int32 transition table + accept vector, built by regex → Thompson
  NFA over the byte alphabet → subset-construction byte DFA (with
  liveness pruning, so a dead byte never admits a token) → token DFA
  (each vocab token's byte string walked through the byte DFA, then
  token-level liveness pruning so no reachable state is a trap with
  no legal token and no accept).
- ``ConstraintTable`` — the engine-owned fixed-shape
  ``[state_cap, V]`` slab the masked programs gather from. Row 0 is
  the unconstrained row (all-allow, self-loop) every unconstrained
  slot points at; each grammar gets a contiguous refcounted block of
  rows. Its device copy is two persistent tensors rewritten in place
  (`ConstraintTable.device`), so a CUDA graph captured on them reads
  every later grammar set.

Terminal states (accepting, no legal continuation) are stored in the
device table as all-allow self-loops so sampling never sees an
all--inf row; the HOST is authoritative — the engine truncates
committed tokens at the terminal boundary and completes the request
(terminal-state → EOS forcing), so device tokens past the terminal
are never observable.

Everything here is host-side numpy; torch is imported only inside
``ConstraintTable.device()``. Validation failures are a typed
``ConstraintError`` raised at ``submit()`` — never mid-decode.

Grammar subset (the reference's docs/serving.md "Constrained
decoding"): literals (unicode ≥ U+0100 encodes utf-8, below as the
single byte), escapes (``\\d \\w \\s`` + negations, control
escapes, ``\\xHH``), char classes (ranges, negation), ``.`` (any
byte but newline), ``* + ?``, bounded ``{m}/{m,}/{m,n}``,
alternation, groups (``(…)`` / ``(?:…)``). Backreferences,
lookaround, lazy quantifiers, and anchors are rejected (patterns are
whole-output anchored by construction).
"""
from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ConstraintError", "CompiledGrammar", "ConstraintTable",
    "compile_grammar", "normalize_constraint", "schema_to_regex",
    "grammar_cache_clear", "grammar_cache_info",
]

# expansion bound for {m,n} repetition (copies of the sub-NFA) and the
# byte-DFA state bound: both exist so a hostile pattern fails fast at
# submit() instead of hanging the compiler
_REP_CAP = 256
_BYTE_DFA_CAP = 8192

_DIGIT = frozenset(range(0x30, 0x3A))
_WORD = frozenset(_DIGIT | set(range(0x41, 0x5B))
                  | set(range(0x61, 0x7B)) | {0x5F})
_SPACE = frozenset({0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20})
_ALL = frozenset(range(256))
_DOT = frozenset(_ALL - {0x0A})
_RE_SPECIAL = set("\\.[](){}*+?|^$")


class ConstraintError(ValueError):
    """Typed rejection of a ``constrain=`` spec at ``submit()``.

    ``reason`` is the rejection class (the metrics label on
    ``serving_constrained_rejections_total``): ``unsupported`` (a
    grammar construct outside the compiled subset), ``invalid``
    (malformed pattern/spec, or a grammar matching nothing),
    ``oversize`` (the token DFA does not fit the engine's
    ``constrain_state_cap`` table), ``empty`` (the grammar accepts
    nothing beyond the already-committed prefix), ``mode``
    (``constrain=`` on a batch-mode engine).
    """

    def __init__(self, msg: str, reason: str = "invalid"):
        super().__init__(msg)
        self.reason = reason


# ----------------------------------------------------------------------
# regex subset -> AST
# ----------------------------------------------------------------------
def _char_bytes(ch: str) -> bytes:
    """A literal character's byte encoding, matching the default vocab
    map: one raw byte below U+0100, utf-8 above."""
    o = ord(ch)
    return bytes([o]) if o < 256 else ch.encode("utf-8")


class _Parser:
    """Recursive-descent parser for the documented regex subset.

    AST nodes are tuples: ``("set", frozenset)`` one byte from a set,
    ``("cat", [n...])``, ``("alt", [n...])``,
    ``("rep", node, lo, hi_or_None)``, ``("eps",)``.
    """

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _err(self, msg: str, reason: str = "invalid") -> ConstraintError:
        return ConstraintError(
            f"regex {self.p!r} at index {self.i}: {msg}", reason)

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise self._err(f"unexpected {self.p[self.i]!r}")
        return node

    def _alt(self):
        parts = [self._concat()]
        while self._peek() == "|":
            self._next()
            parts.append(self._concat())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def _concat(self):
        parts = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        ch = self._peek()
        if ch == "*":
            self._next()
            node = ("rep", node, 0, None)
        elif ch == "+":
            self._next()
            node = ("rep", node, 1, None)
        elif ch == "?":
            self._next()
            node = ("rep", node, 0, 1)
        elif ch == "{":
            bound = self._maybe_bound()
            if bound is None:       # a literal brace, not a quantifier
                return node
            lo, hi = bound
            node = ("rep", node, lo, hi)
        else:
            return node
        if self._peek() in ("?", "+"):
            raise self._err("lazy/possessive quantifiers are not "
                            "supported", "unsupported")
        if self._peek() in ("*", "{"):
            raise self._err("double quantifier")
        return node

    def _maybe_bound(self) -> Optional[Tuple[int, Optional[int]]]:
        """Parse ``{m}``/``{m,}``/``{m,n}``; None when the brace is a
        literal (no digit follows, matching `re`'s lenient reading)."""
        save = self.i
        self._next()                                    # consume '{'
        digits = ""
        while self._peek() is not None and self._peek().isdigit():
            digits += self._next()
        if not digits:
            self.i = save
            return None
        lo = int(digits)
        hi: Optional[int] = lo
        if self._peek() == ",":
            self._next()
            digits = ""
            while self._peek() is not None and self._peek().isdigit():
                digits += self._next()
            hi = int(digits) if digits else None
        if self._peek() != "}":
            self.i = save
            return None
        self._next()
        if hi is not None and hi < lo:
            raise self._err(f"bad repetition bound {{{lo},{hi}}}")
        if max(lo, hi or lo) > _REP_CAP:
            raise self._err(
                f"repetition bound exceeds the expansion cap "
                f"({_REP_CAP})", "oversize")
        return lo, hi

    def _atom(self):
        ch = self._next()
        if ch == "(":
            if self._peek() == "?":
                self._next()
                if self._peek() != ":":
                    raise self._err(
                        "lookaround / named groups are not supported",
                        "unsupported")
                self._next()
            node = self._alt()
            if self._peek() != ")":
                raise self._err("unbalanced parenthesis")
            self._next()
            return node
        if ch == "[":
            return ("set", self._char_class())
        if ch == ".":
            return ("set", _DOT)
        if ch in ("^", "$"):
            raise self._err(
                "anchors are not supported (patterns match the whole "
                "output by construction)", "unsupported")
        if ch in ("*", "+", "?"):
            raise self._err(f"quantifier {ch!r} with nothing to repeat")
        if ch == "\\":
            return self._escape()
        return self._literal(ch)

    def _literal(self, ch: str):
        bs = _char_bytes(ch)
        if len(bs) == 1:
            return ("set", frozenset({bs[0]}))
        return ("cat", [("set", frozenset({b})) for b in bs])

    def _escape(self):
        if self._peek() is None:
            raise self._err("trailing backslash")
        ch = self._next()
        sets = {"d": _DIGIT, "D": _ALL - _DIGIT, "w": _WORD,
                "W": _ALL - _WORD, "s": _SPACE, "S": _ALL - _SPACE}
        if ch in sets:
            return ("set", frozenset(sets[ch]))
        ctrl = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B,
                "0": 0x00}
        if ch in ctrl:
            return ("set", frozenset({ctrl[ch]}))
        if ch == "x":
            hexs = self.p[self.i:self.i + 2]
            if len(hexs) != 2:
                raise self._err("\\x needs two hex digits")
            try:
                b = int(hexs, 16)
            except ValueError:
                raise self._err(f"bad hex escape \\x{hexs}") from None
            self.i += 2
            return ("set", frozenset({b}))
        if ch.isalnum():
            raise self._err(
                f"escape \\{ch} (backreferences, word boundaries, and "
                "anchors) is not supported", "unsupported")
        return self._literal(ch)

    def _class_char(self) -> int:
        """One byte value inside a character class."""
        ch = self._next()
        if ch == "\\":
            if self._peek() is None:
                raise self._err("trailing backslash in class")
            e = self._next()
            ctrl = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C,
                    "v": 0x0B, "0": 0x00}
            if e in ctrl:
                return ctrl[e]
            if e == "x":
                hexs = self.p[self.i:self.i + 2]
                if len(hexs) != 2:
                    raise self._err("\\x needs two hex digits")
                self.i += 2
                return int(hexs, 16)
            if e.isalnum():
                raise self._err(f"escape \\{e} not supported inside a "
                                "character class", "unsupported")
            ch = e
        o = ord(ch)
        if o > 255:
            raise self._err(
                "multi-byte characters in classes are not supported",
                "unsupported")
        return o

    def _char_class(self) -> frozenset:
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        out: set = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise self._err("unterminated character class")
            if ch == "]" and not first:
                self._next()
                break
            first = False
            if ch == "\\":
                nxt = self.p[self.i + 1:self.i + 2]
                if nxt in ("d", "D", "w", "W", "s", "S"):
                    self.i += 2
                    sets = {"d": _DIGIT, "D": _ALL - _DIGIT,
                            "w": _WORD, "W": _ALL - _WORD,
                            "s": _SPACE, "S": _ALL - _SPACE}
                    out |= sets[nxt]
                    continue
            lo = self._class_char()
            if (self._peek() == "-"
                    and self.p[self.i + 1:self.i + 2] not in ("]", "")):
                self._next()
                hi = self._class_char()
                if hi < lo:
                    raise self._err(f"bad class range "
                                    f"{chr(lo)!r}-{chr(hi)!r}")
                out |= set(range(lo, hi + 1))
            else:
                out.add(lo)
        if negate:
            out = set(_ALL) - out
        if not out:
            raise self._err("empty character class")
        return frozenset(out)


# ----------------------------------------------------------------------
# AST -> NFA -> byte DFA
# ----------------------------------------------------------------------
class _NFA:
    def __init__(self):
        self.edges: List[List[Tuple[frozenset, int]]] = []
        self.eps: List[List[int]] = []

    def state(self) -> int:
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1


def _frag(nfa: _NFA, node) -> Tuple[int, int]:
    kind = node[0]
    if kind == "eps":
        s, e = nfa.state(), nfa.state()
        nfa.eps[s].append(e)
        return s, e
    if kind == "set":
        s, e = nfa.state(), nfa.state()
        nfa.edges[s].append((node[1], e))
        return s, e
    if kind == "cat":
        s = e = None
        for child in node[1]:
            fs, fe = _frag(nfa, child)
            if s is None:
                s = fs
            else:
                nfa.eps[e].append(fs)
            e = fe
        return (s, e) if s is not None else _frag(nfa, ("eps",))
    if kind == "alt":
        s, e = nfa.state(), nfa.state()
        for child in node[1]:
            fs, fe = _frag(nfa, child)
            nfa.eps[s].append(fs)
            nfa.eps[fe].append(e)
        return s, e
    if kind == "rep":
        _, sub, lo, hi = node
        s = nfa.state()
        e = s
        for _ in range(lo):
            fs, fe = _frag(nfa, sub)
            nfa.eps[e].append(fs)
            e = fe
        if hi is None:                     # unbounded tail: one loop
            hub = nfa.state()
            nfa.eps[e].append(hub)
            fs, fe = _frag(nfa, sub)
            nfa.eps[hub].append(fs)
            nfa.eps[fe].append(hub)
            out = nfa.state()
            nfa.eps[hub].append(out)
            return s, out
        ends = [e]
        for _ in range(hi - lo):
            fs, fe = _frag(nfa, sub)
            nfa.eps[e].append(fs)
            e = fe
            ends.append(e)
        out = nfa.state()
        for x in ends:
            nfa.eps[x].append(out)
        return s, out
    raise AssertionError(f"unknown AST node {kind!r}")


def _closure(nfa: _NFA, states) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        for t in nfa.eps[stack.pop()]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _byte_dfa(nfa: _NFA, start: int, accept: int, pattern: str):
    """Subset construction + liveness pruning.

    Returns ``(trans, acc)`` where ``trans[i]`` is a dict byte -> live
    target state and ``acc[i]`` says state i accepts; state 0 is the
    start. Raises when the grammar matches no string at all.
    """
    s0 = _closure(nfa, [start])
    ids: Dict[frozenset, int] = {s0: 0}
    order = [s0]
    trans: List[Dict[int, int]] = []
    acc: List[bool] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        acc.append(accept in cur)
        row: Dict[int, int] = {}
        moves: Dict[int, set] = {}
        for st in cur:
            for byteset, tgt in nfa.edges[st]:
                for b in byteset:
                    moves.setdefault(b, set()).add(tgt)
        for b, tgts in moves.items():
            nxt = _closure(nfa, tgts)
            j = ids.get(nxt)
            if j is None:
                j = len(order)
                if j >= _BYTE_DFA_CAP:
                    raise ConstraintError(
                        f"regex {pattern!r}: byte-DFA exceeds "
                        f"{_BYTE_DFA_CAP} states", "oversize")
                ids[nxt] = j
                order.append(nxt)
            row[b] = j
        trans.append(row)
    # liveness: states from which an accepting state is reachable
    rev: List[set] = [set() for _ in order]
    for s, row in enumerate(trans):
        for t in row.values():
            rev[t].add(s)
    live = {s for s, a in enumerate(acc) if a}
    stack = list(live)
    while stack:
        for p in rev[stack.pop()]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise ConstraintError(
            f"regex {pattern!r} matches no string", "invalid")
    trans = [{b: t for b, t in row.items() if t in live}
             for row in trans]
    return trans, acc


def _default_tokens(vocab_size: int) -> List[bytes]:
    """token id -> byte string: raw bytes below 256, utf-8 of the
    code point above (unencodable ids get no bytes — never legal)."""
    out: List[bytes] = []
    for i in range(vocab_size):
        if i < 256:
            out.append(bytes([i]))
        else:
            try:
                out.append(chr(i).encode("utf-8"))
            except (ValueError, UnicodeEncodeError):
                out.append(b"")
    return out


def _token_dfa(btrans, bacc, tokens: Sequence[bytes], pattern: str):
    """Project the byte DFA onto whole-token steps, then prune states
    that cannot reach accept via tokens (byte-level liveness is not
    enough when the vocab does not cover every byte)."""
    walks: Dict[int, Dict[int, int]] = {}   # byte-state -> tok -> tgt
    ids: Dict[int, int] = {0: 0}
    order = [0]
    i = 0
    while i < len(order):
        s = order[i]
        i += 1
        row: Dict[int, int] = {}
        for tid, bs in enumerate(tokens):
            if not bs:
                continue
            cur = s
            ok = True
            for b in bs:
                cur = btrans[cur].get(b)
                if cur is None:
                    ok = False
                    break
            if not ok:
                continue
            row[tid] = cur
            if cur not in ids:
                ids[cur] = len(order)
                order.append(cur)
        walks[s] = row
    acc = {s for s in order if bacc[s]}
    # token-level liveness (reverse reachability from accepting)
    rev: Dict[int, set] = {s: set() for s in order}
    for s, row in walks.items():
        for t in row.values():
            rev[t].add(s)
    live = set(acc)
    stack = list(acc)
    while stack:
        for p in rev[stack.pop()]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise ConstraintError(
            f"regex {pattern!r}: no token sequence of this vocabulary "
            "matches", "invalid")
    # renumber: live states reachable from the start via live targets
    final: Dict[int, int] = {0: 0}
    forder = [0]
    i = 0
    while i < len(forder):
        s = forder[i]
        i += 1
        for t in walks[s].values():
            if t in live and t not in final:
                final[t] = len(forder)
                forder.append(t)
    n = len(forder)
    V = len(tokens)
    allow = np.zeros((n, V), bool)
    trans = np.zeros((n, V), np.int32)
    accept = np.zeros((n,), bool)
    for s in forder:
        ls = final[s]
        trans[ls, :] = ls                  # disallowed: self (inert)
        accept[ls] = s in acc
        for tid, t in walks[s].items():
            if t in live:
                allow[ls, tid] = True
                trans[ls, tid] = final[t]
    return allow, trans, accept


# ----------------------------------------------------------------------
# the compiled artifact + host-side state machine
# ----------------------------------------------------------------------
class CompiledGrammar:
    """Dense token DFA over one vocabulary. States are LOCAL (0 =
    start); the engine adds the ``ConstraintTable`` row base for the
    device-side global id. The host copy is authoritative: ``advance``
    raises on an illegal token, ``replay`` re-derives the state of a
    committed prefix (the failover/requeue path), ``is_terminal``
    marks accepting states with no legal continuation (the EOS-forcing
    trigger)."""

    __slots__ = ("key", "spec", "num_states", "vocab_size", "allow",
                 "trans", "accept", "terminal")

    def __init__(self, key: str, spec: dict, allow: np.ndarray,
                 trans: np.ndarray, accept: np.ndarray):
        self.key = key
        self.spec = spec
        self.allow = allow
        self.trans = trans
        self.accept = accept
        self.terminal = accept & ~allow.any(axis=1)
        self.num_states = int(allow.shape[0])
        self.vocab_size = int(allow.shape[1])

    def legal(self, state: int, tok: int) -> bool:
        return bool(self.allow[state, tok])

    def advance(self, state: int, tok: int) -> int:
        if not self.allow[state, tok]:
            raise ConstraintError(
                f"token {tok} is not grammar-legal in state {state}",
                "invalid")
        return int(self.trans[state, tok])

    def replay(self, toks) -> int:
        state = 0
        for t in np.asarray(toks, np.int64).ravel().tolist():
            state = self.advance(state, int(t))
        return state

    def is_terminal(self, state: int) -> bool:
        return bool(self.terminal[state])

    def accepts(self, state: int) -> bool:
        return bool(self.accept[state])


# ----------------------------------------------------------------------
# spec normalization + JSON-schema lowering
# ----------------------------------------------------------------------
def _re_escape(s: str) -> str:
    return "".join("\\" + c if c in _RE_SPECIAL else c for c in s)


def schema_to_regex(schema) -> str:
    """Lower the supported JSON-schema subset to a regex over compact
    (no-whitespace) JSON text. Objects emit every declared property in
    declaration order; strings are quote-delimited escapeless runs
    (or an explicit ``pattern``/``enum``); numbers are bounded so
    every grammar has a reachable terminal state. Unsupported
    combinators raise a typed ``ConstraintError``."""
    if not isinstance(schema, dict):
        raise ConstraintError(
            f"json_schema must be an object, got "
            f"{type(schema).__name__}", "invalid")
    for k in ("anyOf", "oneOf", "allOf", "not", "$ref"):
        if k in schema:
            raise ConstraintError(
                f"json_schema combinator {k!r} is not supported",
                "unsupported")
    if "enum" in schema:
        alts = "|".join(
            _re_escape(json.dumps(v, separators=(",", ":")))
            for v in schema["enum"])
        return f"({alts})"
    t = schema.get("type")
    if t == "string":
        if "pattern" in schema:
            return f'"(?:{schema["pattern"]})"'
        n = schema.get("maxLength")
        body = f'[^"\\\\]{{0,{int(n)}}}' if n is not None \
            else '[^"\\\\]*'
        return f'"{body}"'
    if t == "integer":
        return "(-?(0|[1-9][0-9]{0,5}))"
    if t == "number":
        return "(-?(0|[1-9][0-9]{0,5})(\\.[0-9]{1,6})?)"
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise ConstraintError("object properties must be a map",
                                  "invalid")
        if not props:
            return "\\{\\}"
        fields = ",".join(
            f'"{_re_escape(k)}":{schema_to_regex(v)}'
            for k, v in props.items())
        return "\\{" + fields + "\\}"
    if t == "array":
        if "items" not in schema:
            raise ConstraintError("array schema needs items",
                                  "unsupported")
        if "maxItems" not in schema:
            raise ConstraintError(
                "unbounded arrays are not supported: set maxItems",
                "unsupported")
        item = schema_to_regex(schema["items"])
        lo = int(schema.get("minItems", 0))
        hi = int(schema["maxItems"])
        if hi < lo:
            raise ConstraintError("maxItems < minItems", "invalid")
        if hi == 0:
            return "\\[\\]"
        if lo == 0:
            return f"\\[({item}(,{item}){{0,{hi - 1}}})?\\]"
        return f"\\[{item}(,{item}){{{lo - 1},{hi - 1}}}\\]"
    raise ConstraintError(
        f"json_schema type {t!r} is not supported", "unsupported")


def normalize_constraint(constrain) -> Tuple[dict, int]:
    """Canonicalize a ``submit(constrain=…)`` value into
    ``(spec, consumed)``: a bare string is a regex; dicts carry
    ``type`` (``regex``/``json_schema``) and an optional ``consumed``
    count of trailing prompt tokens already inside the grammar (the
    fleet's failover hop sets it to the committed prefix length). The
    returned spec is JSON-able and consumed-free, so one grammar hash
    covers every hop of a request's life."""
    if isinstance(constrain, str):
        return {"type": "regex", "pattern": constrain}, 0
    if not isinstance(constrain, dict):
        raise ConstraintError(
            "constrain= must be a regex string or a spec dict, got "
            f"{type(constrain).__name__}", "invalid")
    d = dict(constrain)
    consumed = d.pop("consumed", 0)
    if not isinstance(consumed, int) or consumed < 0:
        raise ConstraintError(
            f"constrain consumed= must be a non-negative int, got "
            f"{consumed!r}", "invalid")
    t = d.get("type")
    if t == "regex":
        if set(d) != {"type", "pattern"} or \
                not isinstance(d.get("pattern"), str):
            raise ConstraintError(
                "regex spec must be {'type': 'regex', 'pattern': str}",
                "invalid")
    elif t == "json_schema":
        if set(d) != {"type", "schema"} or \
                not isinstance(d.get("schema"), dict):
            raise ConstraintError(
                "json_schema spec must be {'type': 'json_schema', "
                "'schema': {...}}", "invalid")
    else:
        raise ConstraintError(
            f"constrain type {t!r} is not supported (regex, "
            "json_schema)", "unsupported")
    return d, consumed


# ----------------------------------------------------------------------
# module-level compile cache, keyed by grammar hash x vocab
# ----------------------------------------------------------------------
_CACHE: Dict[Tuple[str, int], CompiledGrammar] = {}
_CACHE_LOCK = threading.Lock()
_CACHE_MISSES = 0


def grammar_key(spec: dict, vocab_size: int) -> str:
    return hashlib.sha256(
        (json.dumps(spec, sort_keys=True) + f"|V{vocab_size}")
        .encode()).hexdigest()


def grammar_cache_clear() -> None:
    global _CACHE_MISSES
    with _CACHE_LOCK:
        _CACHE.clear()
        _CACHE_MISSES = 0


def grammar_cache_info() -> Tuple[int, int]:
    with _CACHE_LOCK:
        return len(_CACHE), _CACHE_MISSES


def compile_grammar(spec, vocab_size: int, state_cap: int = 512,
                    tokens: Optional[Sequence[bytes]] = None
                    ) -> CompiledGrammar:
    """Compile (or fetch from the hash-keyed cache) one constraint
    spec against one vocabulary. ``state_cap`` is the engine's table
    bound — a grammar needing more than ``state_cap - 1`` states (row
    0 is reserved for unconstrained slots) raises ``oversize`` even
    on a cache hit. Custom ``tokens`` (an explicit id -> bytes map)
    bypass the cache."""
    global _CACHE_MISSES
    spec, _ = normalize_constraint(spec)
    key = grammar_key(spec, vocab_size)
    g: Optional[CompiledGrammar] = None
    if tokens is None:
        with _CACHE_LOCK:
            g = _CACHE.get((key, vocab_size))
    if g is None:
        if spec["type"] == "regex":
            pattern = spec["pattern"]
        else:
            pattern = schema_to_regex(spec["schema"])
        ast = _Parser(pattern).parse()
        nfa = _NFA()
        start, end = _frag(nfa, ast)
        btrans, bacc = _byte_dfa(nfa, start, end, pattern)
        toks = list(tokens) if tokens is not None \
            else _default_tokens(vocab_size)
        if len(toks) != vocab_size:
            raise ConstraintError(
                f"token map has {len(toks)} entries for vocab "
                f"{vocab_size}", "invalid")
        allow, trans, accept = _token_dfa(btrans, bacc, toks, pattern)
        g = CompiledGrammar(key, spec, allow, trans, accept)
        if tokens is None:
            with _CACHE_LOCK:
                _CACHE[(key, vocab_size)] = g
                _CACHE_MISSES += 1
    if g.num_states > state_cap - 1:
        raise ConstraintError(
            f"grammar needs {g.num_states} DFA states but "
            f"constrain_state_cap={state_cap} reserves row 0, leaving "
            f"{state_cap - 1} (table bound: cap x vocab x 5 = "
            f"{state_cap * vocab_size * 5} bytes)", "oversize")
    return g


# ----------------------------------------------------------------------
# the engine-owned fixed-shape mask table
# ----------------------------------------------------------------------
class ConstraintTable:
    """The ``[state_cap, V]`` allow/transition slab every masked
    program gathers from. The SHAPE is fixed at engine construction
    (``EngineConfig.constrain_state_cap``) so the mask operands never
    change an aval — grammars come and go as pure data.

    Row 0 is the unconstrained row: all-allow, self-loop — every
    unconstrained slot's state. Each grammar occupies a contiguous
    refcounted row block; terminal rows are stored all-allow
    self-loops (sampling never sees an all--inf row; the host
    truncates at the terminal instead). Released blocks stay resident
    for cache-friendly resubmits; when an acquire needs room and no
    grammar is referenced, the table resets wholesale. An acquire
    that cannot fit raises the documented ``oversize``
    ``ConstraintError`` (bound: ``state_cap * V * 5`` bytes — one
    bool + one int32 per cell)."""

    def __init__(self, state_cap: int, vocab_size: int):
        if state_cap < 2:
            raise ValueError("constrain_state_cap must be >= 2")
        self.state_cap = int(state_cap)
        self.vocab_size = int(vocab_size)
        self.allow = np.ones((self.state_cap, self.vocab_size), bool)
        self.trans = np.zeros((self.state_cap, self.vocab_size),
                              np.int32)
        self._slabs: Dict[str, List[int]] = {}  # key -> [base, n, ref]
        self._next = 1
        self._version = 0
        self._dev = None          # the device (allow, trans), made once
        self._dev_version = -1
        self._lock = threading.Lock()

    @property
    def rows_used(self) -> int:
        return self._next

    def bound_bytes(self) -> int:
        return self.state_cap * self.vocab_size * 5

    def acquire(self, g: CompiledGrammar) -> int:
        """Reserve (or re-reference) ``g``'s row block; returns the
        global row base."""
        with self._lock:
            slab = self._slabs.get(g.key)
            if slab is not None:
                slab[2] += 1
                return slab[0]
            if self._next + g.num_states > self.state_cap:
                self._reset_locked()
            if self._next + g.num_states > self.state_cap:
                raise ConstraintError(
                    f"constraint table overflow: grammar needs "
                    f"{g.num_states} states, "
                    f"{self.state_cap - self._next} of "
                    f"constrain_state_cap={self.state_cap} free "
                    f"(bound: {self.bound_bytes()} bytes); raise "
                    "EngineConfig.constrain_state_cap", "oversize")
            base = self._next
            self._write_locked(g, base)
            self._slabs[g.key] = [base, g.num_states, 1]
            self._next += g.num_states
            self._version += 1
            return base

    def release(self, key: str) -> None:
        with self._lock:
            slab = self._slabs.get(key)
            if slab is not None and slab[2] > 0:
                slab[2] -= 1

    def _reset_locked(self) -> None:
        if any(s[2] for s in self._slabs.values()):
            return
        self._slabs.clear()
        self._next = 1
        self.allow[1:] = True
        self.trans[1:] = 0
        self._version += 1

    def _write_locked(self, g: CompiledGrammar, base: int) -> None:
        n = g.num_states
        allow = g.allow.copy()
        trans = (base + g.trans).astype(np.int32)
        if g.terminal.any():
            rows = np.nonzero(g.terminal)[0]
            allow[rows] = True
            trans[rows] = (base + rows).astype(np.int32)[:, None]
        self.allow[base:base + n] = allow
        self.trans[base:base + n] = trans

    def device(self, device):
        """The table on ``device``: two persistent tensors, allow
        [C, V] bool and trans [C, V] int32, made at the first call and
        rewritten in place (``copy_``, stream-ordered after the calls
        already queued) when the content version moves: one
        host-to-device copy per grammar-set change, nothing per tick.
        The same tensor objects serve every version, since captured
        CUDA graphs read them by address. Returns the same (allow,
        trans) tuple object on every call."""
        import torch
        with self._lock:
            if self._dev is None:
                self._dev = (torch.empty(self.allow.shape, dtype=torch.bool,
                                         device=device),
                             torch.empty(self.trans.shape,
                                         dtype=torch.int32, device=device))
            if self._dev_version != self._version:
                for dst, src in zip(self._dev, (self.allow, self.trans)):
                    host = torch.from_numpy(src.copy())
                    if dst.is_cuda:
                        host = host.pin_memory()
                    dst.copy_(host, non_blocking=dst.is_cuda)
                self._dev_version = self._version
            return self._dev
