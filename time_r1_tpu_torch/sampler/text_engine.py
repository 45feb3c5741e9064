"""Text-level generation over a token engine (port of
`time_r1_tpu/sampler/text_engine.py`).

On top of an engine's token-level `generate` (`Engine`, `ContinuousEngine`
or `PagedEngine`):
- decode to text with the stop token kept (skip_special_tokens=False);
- the two-pass MCQ answer forcing: cut each completion at its last
  "<answer>", append "<answer>\\n{answer_prompt}", and generate 16 more
  tokens;
- `extract_timestamps` (the last two numbers of a response).

`processor` is any object with `.decode(ids, skip_special_tokens=...)` and
`.tokenizer.encode(s, add_special_tokens=False)`, such as the port's
`models.processor.Qwen25VLProcessor`.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

from .engine import Request
from .params import SamplingParams


class TextEngine:
    def __init__(self, engine, processor):
        self.engine = engine
        self.processor = processor
        self.cfg = engine.cfg

    @staticmethod
    def find_answer_token_last_occurrence(text: str) -> int:
        return text.rfind("<answer>")

    @staticmethod
    def extract_timestamps(response: str):
        matches = re.findall(r"\d+(?:\.\d+)?", response)
        out = [float(n) for n in matches[-2:]]
        if len(out) == 2:
            return out[0], out[1]
        return None, None

    def generate(
        self,
        requests: Sequence[Request],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = -1,
        repetition_penalty: float = 1.0,
        seed: Optional[int] = None,
        answer_prompt: Optional[str] = None,
    ) -> List[str]:
        sp = SamplingParams(
            temperature=temperature,
            top_p=top_p or 1.0,
            top_k=top_k or -1,
            max_new_tokens=max_new_tokens,
            stop_token_ids=self.cfg.stop_token_ids,
            include_stop_token=True,
            repetition_penalty=repetition_penalty or 1.0,
            seed=seed,
        )
        token_out = self.engine.generate(list(requests), sp)
        preds = [self.processor.decode(t, skip_special_tokens=False) for t in token_out]
        if answer_prompt is None:
            return preds

        indices = [self.find_answer_token_last_occurrence(t) for t in preds]
        cont_requests, cont_rows = [], []
        for i, req in enumerate(requests):
            if indices[i] == -1:
                continue
            new_ids = self.processor.tokenizer.encode(
                preds[i][: indices[i]] + "<answer>\n" + answer_prompt, add_special_tokens=False
            )
            cont_requests.append(Request(
                input_ids=list(req.input_ids) + list(new_ids),
                patches=req.patches,
                grid_thw=req.grid_thw,
                second_per_grid_t=req.second_per_grid_t,
            ))
            cont_rows.append(i)
        if cont_requests:
            sp2 = SamplingParams(
                temperature=temperature,
                top_p=top_p or 1.0,
                top_k=top_k or -1,
                max_new_tokens=16,
                stop_token_ids=self.cfg.stop_token_ids,
                include_stop_token=True,
                seed=seed,
            )
            cont_out = self.engine.generate(cont_requests, sp2)
            for row, toks in zip(cont_rows, cont_out):
                tail = self.processor.decode(toks, skip_special_tokens=False)
                preds[row] = preds[row][: indices[row]] + "<answer>\n" + answer_prompt + tail
        return preds
