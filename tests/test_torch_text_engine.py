"""The port's TextEngine against the JAX package's
(`time_r1_tpu/sampler/text_engine.py`) over the same stub token engine and
tests/tiny_tokenizer.py: decode to text, the two-pass MCQ answer forcing,
the sampling parameters each pass asks for, and `extract_timestamps`."""

import pytest

from test_torch_bridge import CFG, JCFG
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.models.processor import Qwen25VLProcessor
from time_r1_tpu.sampler.engine import Request as JaxRequest
from time_r1_tpu.sampler.text_engine import TextEngine as JaxTextEngine
from time_r1_tpu_torch.sampler import Request, TextEngine


class StubEngine:
    """Canned completions; records each call's prompts and sampling parameters."""

    def __init__(self, cfg, outputs):
        self.cfg = cfg
        self.outputs = list(outputs)
        self.calls = []

    def generate(self, requests, sp):
        self.calls.append(([list(r.input_ids) for r in requests],
                           (sp.temperature, sp.top_p, sp.top_k, sp.max_new_tokens, tuple(sp.stop_token_ids),
                            sp.include_stop_token, sp.seed)))
        out, self.outputs = self.outputs[: len(requests)], self.outputs[len(requests):]
        return out


PROCESSOR = Qwen25VLProcessor(TinyTokenizer(), pad_token_id=CFG.pad_token_id, eos_token_id=CFG.eos_token_id)


def _tok(s):
    return PROCESSOR.tokenizer.encode(s, add_special_tokens=False)


def _both(outputs, prompts, **kw):
    """The same stub outputs through both TextEngines: (texts, stub calls) of each."""
    out = []
    for engine_cls, request_cls, cfg in ((TextEngine, Request, CFG), (JaxTextEngine, JaxRequest, JCFG)):
        stub = StubEngine(cfg, outputs)
        reqs = [request_cls(input_ids=_tok(p)) for p in prompts]
        out.append((engine_cls(stub, PROCESSOR).generate(reqs, **kw), stub.calls))
    return out


def test_two_pass_answer_forcing_matches_jax():
    first = _tok("thinking... <answer>maybe (B)") + [1]
    no_tag = _tok("no answer tag here") + [1]
    third = _tok("<answer>x</answer> and <answer>(C") + [1]
    outputs = [first, no_tag, third, _tok("A)") + [1], _tok("D)")]
    (got, calls), (want, jcalls) = _both(outputs, ["q1", "q2", "q3"], max_new_tokens=8,
                                         answer_prompt="Best Option: (", seed=3)
    assert got == want and calls == jcalls
    # row 0: cut at its last <answer>, the forcing prompt appended, the continuation merged
    assert got[0] == "thinking... <answer>\nBest Option: (A)<|im_end|>"
    assert got[1] == "no answer tag here<|im_end|>"  # no <answer>: untouched
    assert got[2] == "<answer>x</answer> and <answer>\nBest Option: (D)"
    prompts, sp2 = calls[1]
    assert prompts[0] == _tok("q1") + _tok("thinking... <answer>\nBest Option: (") and len(prompts) == 2
    assert sp2[3] == 16 and sp2[4] == CFG.stop_token_ids and sp2[5] and sp2[6] == 3


def test_single_pass_decodes_with_the_stop_token_kept():
    outputs = [_tok("from 3.5 to 7") + [1], _tok("nothing")]
    (got, calls), (want, jcalls) = _both(outputs, ["a", "b"], max_new_tokens=12, temperature=0.7, top_p=0.9,
                                         top_k=20, seed=1)
    assert got == want == ["from 3.5 to 7<|im_end|>", "nothing"] and calls == jcalls
    assert calls[0][1] == (0.7, 0.9, 20, 12, CFG.stop_token_ids, True, 1)


@pytest.mark.parametrize("text", [
    "from 3.5 to 7 and then 9.25", "only 4.2", "", "<answer>12.0 to 15.5</answer>", "a1b2c3", "between 0 and 10.",
])
def test_extract_timestamps_matches_jax(text):
    assert TextEngine.extract_timestamps(text) == JaxTextEngine.extract_timestamps(text)
