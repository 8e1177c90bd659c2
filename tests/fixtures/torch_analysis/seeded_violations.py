"""Seeded-violation fixture of the port's linter (RPT rules).

A line-for-line translation of ``tests/fixtures/analysis``'s: RPT001, RPT003
and RPT007 fire at its RPR lines (``jnp`` made ``torch``; the cached member
is not ``stacked``, the port's sanctioned conversion).  Never imported.
"""
import time
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from functools import cached_property


@dataclass
class SparseConfig:
    ghost_knob: int = 0  # RPT006: never read anywhere in this tree

X = torch.ones((4,), device="cuda")  # RPT007: module-level device tensor


class AttentionPlan:
    @cached_property
    def descriptors(self):
        # RPT001 (a cached tensor keeps its first touch's device and mode)
        # + RPT003 (torch in a host-only zone):
        return torch.stack([torch.arange(4), torch.arange(4)])


def build_plan(context_len):
    return torch.arange(context_len)  # RPT003: host-only builder


def replay_and_reuse(graph, cache, tokens):
    logits, cache = graph(cache, tokens)
    graph(cache, tokens)
    return logits  # RPT002: the replay above overwrote it


async def serve_loop(engine):
    while True:
        engine.step()  # RPT004: blocking engine tick on the event loop
        time.sleep(0.1)  # RPT004: blocking sleep on the event loop


class Engine:
    def tick(self, tokens):
        out = self.decode_step_fn(tokens)
        # RPT005: injection site fires after the step dispatch above.
        self._fault.check_raise("decode", tick=0)
        return out


def suppressed_ok(plan):
    return F.pad(torch.as_tensor(plan), (0, 1))  # noqa: RPT009 -- RPT008
