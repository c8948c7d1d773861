"""The decode step as one captured CUDA graph: the port's counterpart of
the reference's jitted ``decode_fn`` (``repro.serving.engine``,
``ModelBundle.create``).

A :class:`DecodeGraphs` belongs to one bundle.  Per key (shard batch,
``max_len``) it keeps a :class:`StaticDecode`: a static cache from
``model.init_cache``, the token fed to the next step ``[B, 1]``, the
position as a 0-d int64 tensor on the device (the reference's traced
``pos``), the tokens generated so far ``[B, max_len]`` (column ``p`` holds
the token at position ``p``) and, on the card, one CUDA graph of a whole
decode step: every layer, the argmax, the new token written into the token
buffer and into its column, the position advanced.  A stage zeroes the
static cache (RWKV6's and Mamba2's prefill read their initial state from
it), prefills into it eagerly and replays the graph; nothing is read back
to the host in between.

A key's graph is captured at its first stage, right after that stage's
first decode step has run eagerly on the capture's stream.  That step
warms up cuBLAS, the allocator and K2's scratch on that stream, as
PyTorch's capture rules ask, and it is the stage's real first step: the
capture runs nothing, so the replays go on from the state it left.  A
capture that fails raises; there is no eager path to fall back to on the
card.  The graphs and their memory pools go with their bundle.

The kernels' wrappers count their Python calls (``kernels.ops``), so the
calls made during a capture would count launches that did not run, and a
replay calls no wrapper.  A capture's counts are therefore taken back and
kept with its graph, and every replay adds them: the counts say what ran
on the card.

On the CPU the same static buffers and the same device-integer step run
eagerly: there are no graphs there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


class StaticDecode:
    """The static buffers of one (shard batch, ``max_len``) key and, once
    captured, the CUDA graph of its decode step."""

    def __init__(self, model, params, batch: int, max_len: int):
        dev = model.device
        self.model, self.params = model, params
        self.cache = model.init_cache(batch, max_len)
        self.token = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.tokens = torch.zeros((batch, max_len), dtype=torch.int64,
                                  device=dev)
        self.graph = None
        self.graph_logits = None     # the graph's logits, after a replay
        self.graph_counts: dict = {}  # kernel launches of one replay

    def prefill(self, prompts: torch.Tensor, extra_embeds=None) -> None:
        """Zero the cache, prefill ``prompts`` [B, P] (and an
        encoder-decoder model's frames, ``extra_embeds``) into it eagerly,
        and set the first generated token (at position P) and the
        position."""
        plen = prompts.shape[1]
        for leaf in _leaves(self.cache):
            leaf.zero_()
        logits, _ = self.model.prefill(self.params, prompts, self.cache,
                                       extra_embeds)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        self.token.copy_(tok)
        self.tokens[:, plen: plen + 1] = tok
        self.pos.fill_(plen)

    def step(self) -> torch.Tensor:
        """One decode step, run eagerly (or recorded, under a capture);
        returns its logits [B, 1, vocab]."""
        logits, _ = self.model.decode_step(self.params, self.token,
                                           self.cache, self.pos)
        tok = torch.argmax(logits, dim=-1)
        self.token.copy_(tok)
        self.pos.add_(1)
        self.tokens.index_copy_(1, self.pos.view(1), tok)
        return logits

    def capture(self, stream: torch.cuda.Stream) -> None:
        """Record :meth:`step` into a CUDA graph on ``stream``; the
        capture's launch counts become the graph's."""
        graph = torch.cuda.CUDAGraph()
        before = ops.counts()
        with torch.cuda.graph(graph, stream=stream):
            self.graph_logits = self.step()
        after = ops.counts()
        self.graph_counts = {k: after[k] - before[k] for k in after}
        ops.add_counts({k: -n for k, n in self.graph_counts.items()})
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        ops.add_counts(self.graph_counts)


class DecodeGraphs:
    """A bundle's decode steps: one :class:`StaticDecode` per key, its
    step captured as a CUDA graph on the card.  ``replays`` and
    ``eager_steps`` count the decode steps run each way, ``captures`` the
    graphs made."""

    def __init__(self, model, params):
        self.model, self.params = model, params
        self.slots: dict[tuple[int, int], StaticDecode] = {}
        self.replays = self.eager_steps = self.captures = 0
        self._stream = None

    def slot(self, batch: int, max_len: int) -> StaticDecode:
        """The static buffers of key (``batch``, ``max_len``), made at
        first use."""
        key = (batch, max_len)
        if key not in self.slots:
            self.slots[key] = StaticDecode(self.model, self.params, batch,
                                           max_len)
        return self.slots[key]

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, gen_len: int, max_len: int,
                 extra_embeds=None):
        """Greedy tokens [B, gen_len] of ``prompts`` [B, P] (``P +
        gen_len <= max_len``; an encoder-decoder model's frames as
        ``extra_embeds``): the prefill's token, then ``gen_len - 1``
        decode steps.  Returns them (a copy) and the static cache they
        were decoded in, which the next stage of the same key reuses."""
        b, plen = prompts.shape
        if plen + gen_len > max_len:
            raise ValueError(f"{plen} prompt and {gen_len} generated "
                             f"tokens exceed max_len {max_len}")
        slot = self.slot(b, max_len)
        slot.prefill(prompts, extra_embeds)
        steps = gen_len - 1
        if steps > 0 and self.model.device.type == "cuda":
            if slot.graph is None:
                self._step_and_capture(slot)
                steps -= 1
            for _ in range(steps):
                slot.replay()
            self.replays += steps
        else:
            for _ in range(steps):
                slot.step()
            self.eager_steps += steps
        return slot.tokens[:, plen: plen + gen_len].clone(), slot.cache

    def _step_and_capture(self, slot: StaticDecode) -> None:
        """The stage's first decode step, eagerly, then the capture of the
        next one, both on the capture's own stream."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.model.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            slot.step()
            slot.capture(stream)
        torch.cuda.current_stream().wait_stream(stream)
        self.eager_steps += 1
        self.captures += 1
