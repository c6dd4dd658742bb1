"""Prompt-ensemble class-text tables.

Port of ``clipspm_tpu/models/text_features.py``: every (template, class)
prompt tokenizes into one stream of padded ``[512, context]`` batches
through the text tower; the template mean gives a ``[C, D]`` table per
class-name list.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .backbones.clip import CLIPModel
from .backbones.tokenizer import SimpleTokenizer, tokenize

# The 16-template prompt ensemble of the clipspm head.
PROMPT_TEMPLATES: List[str] = [
    "a photo of action {}", "a picture of action {}", "Human action of {}",
    "{}, an action", "{} this is an action", "{}, a video of action",
    "Playing action of {}", "{}", "Playing a kind of action, {}",
    "Doing a kind of action, {}", "Look, the human is {}",
    "Can you recognize the action of {}?", "Video classification of {}",
    "A video of {}", "The man is {}", "The woman is {}",
]

# Single-template variant of the clipfsar/sten heads.
SINGLE_TEMPLATE = ["a photo of {}"]


@torch.no_grad()
def encode_class_text_tables(model: CLIPModel,
                             name_lists: Sequence[Sequence[str]],
                             templates: Optional[Sequence[str]] = None,
                             tokenizer: Optional[SimpleTokenizer] = None,
                             batch_size: int = 512) -> List[torch.Tensor]:
    """Encode several class-name lists (train + test) in one stream of
    padded batches; return one ``[num_classes, embed_dim]``
    template-averaged table per list, on the model's device."""
    templates = list(templates or PROMPT_TEMPLATES)
    prompts = [t.format(name) for names in name_lists
               for t in templates for name in names]
    if tokenizer is None and model.arch.vocab_size != 49408:
        # non-standard (test) vocab: a tokenizer whose ids fit the table
        tokenizer = SimpleTokenizer(vocab_size=model.arch.vocab_size)
    tokens = torch.from_numpy(tokenize(
        prompts, context_length=model.arch.context_length, truncate=True,
        tokenizer=tokenizer))
    device = model.positional_embedding.device

    b = min(batch_size, max(8, tokens.shape[0]))
    feats = []
    for i in range(0, tokens.shape[0], b):
        chunk = tokens[i: i + b]
        n = chunk.shape[0]
        if n < b:   # one batch shape for the whole stream
            chunk = torch.cat([chunk, chunk.new_zeros((b - n,) + chunk.shape[1:])])
        feats.append(model.encode_text(chunk.to(device))[:n])
    flat = torch.cat(feats, dim=0)

    tables: List[torch.Tensor] = []
    off = 0
    for names in name_lists:
        block = flat[off: off + len(templates) * len(names)]
        off += block.shape[0]
        tables.append(block.reshape(len(templates), len(names), -1).mean(dim=0))
    return tables


def encode_class_text_features(model: CLIPModel,
                               class_names: Sequence[str],
                               templates: Optional[Sequence[str]] = None,
                               tokenizer: Optional[SimpleTokenizer] = None,
                               batch_size: int = 512) -> torch.Tensor:
    """Returns the ``[num_classes, embed_dim]`` template-averaged table."""
    return encode_class_text_tables(model, [class_names], templates,
                                    tokenizer=tokenizer,
                                    batch_size=batch_size)[0]
