"""Aho-Corasick context graph for keyword spotting.

TPU-native analog of the reference's keyword graph
(reference: Sources/SpeechWakeWord/ContextGraph.swift:9-213, itself a port
of icefall's context_graph.py): a trie over keyword BPE-token sequences
with Aho-Corasick fail/output links and *scored* nodes — every accepted
token contributes a per-token boost (``token_score``) to the beam-search
hypothesis log-prob, terminal nodes carry the keyword phrase and its
acoustic-probability threshold, and falling off a keyword path refunds the
accumulated boost (score bookkeeping via ``node_score``/``output_score``).
Pure host-side control logic — the encoder posteriors come from the jitted
Zipformer program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Keyword:
    """One registered keyword (reference: KeywordSpec,
    Configuration.swift:100-127). ``threshold``/``boost`` of 0 fall back to
    the graph-level defaults."""

    name: str
    token_ids: Sequence[int]
    threshold: float = 0.0
    boost: float = 0.0


class ContextState:
    __slots__ = ("id", "token", "token_score", "node_score", "output_score",
                 "is_end", "level", "phrase", "ac_threshold", "next", "fail",
                 "output")

    def __init__(self, id: int, token: int, token_score: float,
                 node_score: float, output_score: float, is_end: bool,
                 level: int, phrase: str = "", ac_threshold: float = 1.0):
        self.id = id
        self.token = token
        self.token_score = token_score
        self.node_score = node_score
        self.output_score = output_score
        self.is_end = is_end
        self.level = level
        self.phrase = phrase
        self.ac_threshold = ac_threshold
        self.next: Dict[int, "ContextState"] = {}
        self.fail: Optional["ContextState"] = None
        self.output: Optional["ContextState"] = None


class ContextGraph:
    """Scored Aho-Corasick automaton (ContextGraph.swift:48-213)."""

    def __init__(self, keywords: Sequence[Keyword] = (),
                 context_score: float = 0.5, ac_threshold: float = 0.15):
        self.context_score = context_score
        self.ac_threshold = ac_threshold
        self.keywords = list(keywords)
        self.num_nodes = 0
        self.root = ContextState(0, -1, 0.0, 0.0, 0.0, False, 0)
        self.root.fail = self.root
        if keywords:
            self.build(keywords)

    def build(self, keywords: Sequence[Keyword]) -> None:
        for kw in keywords:
            tokens = list(kw.token_ids)
            if not tokens:
                continue
            score = kw.boost if kw.boost != 0 else self.context_score
            threshold = kw.threshold if kw.threshold != 0 else self.ac_threshold
            node = self.root
            for i, token in enumerate(tokens):
                is_end = i == len(tokens) - 1
                existing = node.next.get(token)
                if existing is not None:
                    existing.token_score = max(score, existing.token_score)
                    existing.node_score = node.node_score + existing.token_score
                    combined_end = existing.is_end or is_end
                    existing.output_score = existing.node_score if combined_end else 0.0
                    existing.is_end = combined_end
                    if is_end:
                        existing.phrase = kw.name
                        existing.ac_threshold = threshold
                    node = existing
                else:
                    self.num_nodes += 1
                    node_score = node.node_score + score
                    new = ContextState(
                        self.num_nodes, token, score, node_score,
                        node_score if is_end else 0.0, is_end, i + 1,
                        kw.name if is_end else "",
                        threshold if is_end else 0.0)
                    node.next[token] = new
                    node = new
        self._fill_fail_and_output()

    def _fill_fail_and_output(self) -> None:
        queue: List[ContextState] = []
        for node in self.root.next.values():
            node.fail = self.root
            queue.append(node)
        cursor = 0
        while cursor < len(queue):
            current = queue[cursor]
            cursor += 1
            for token, node in current.next.items():
                fail = current.fail or self.root
                if token in fail.next:
                    fail = fail.next[token]
                else:
                    fail = fail.fail or self.root
                    while token not in fail.next:
                        if fail.token == -1:
                            break
                        fail = fail.fail or self.root
                    if token in fail.next:
                        fail = fail.next[token]
                node.fail = fail

                output: Optional[ContextState] = node.fail
                while output is not None and not output.is_end:
                    nf = output.fail
                    if nf is not None and nf.token != -1:
                        output = nf
                    else:
                        output = None
                        break
                node.output = output
                node.output_score += output.output_score if output else 0.0
                queue.append(node)

    def forward_one_step(self, state: ContextState, token: int
                         ) -> Tuple[float, ContextState, Optional[ContextState]]:
        """Advance by one token → (boost_score, next_state, matched_end?).
        Following a fail link refunds the score difference so a hypothesis
        that leaves a keyword path loses its accumulated boost
        (ContextGraph.swift:168-199)."""
        direct = state.next.get(token)
        if direct is not None:
            node = direct
            score = node.token_score
        else:
            fail = state.fail or self.root
            while token not in fail.next:
                if fail.token == -1:
                    break
                fail = fail.fail or self.root
            node = fail.next.get(token, fail)
            score = node.node_score - state.node_score

        if node.is_end:
            matched: Optional[ContextState] = node
        elif node.output is not None:
            matched = node.output
        else:
            matched = None
        return score + node.output_score, node, matched

    def is_matched(self, state: ContextState
                   ) -> Tuple[bool, Optional[ContextState]]:
        if state.is_end:
            return True, state
        if state.output is not None:
            return True, state.output
        return False, None

    def finalize(self, state: ContextState) -> Tuple[float, ContextState]:
        """Cancel accumulated boost when resetting to root."""
        return -state.node_score, self.root
