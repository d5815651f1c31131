"""Chat: each request is one of the mix's system prompts, then a user turn.

Keys: `system_prompts` `{"count", "tokens", "zipf"}` (each request's system
prompt by Zipf weight over the count: tenants of unequal size; the
prompts' tokens drawn from the seed), lengths `user_tokens` and
`output_tokens`, `token_zipf` and `phase_requests` (the user turn's
tokens), `block` and `size_seed`. Every seed serves the same set of
sizes: a block's sizes are drawn once from the fixed `size_seed`, and
each seed only permutes them within every block."""
import numpy as np

from mix import Generator, lengths, rng


class Traffic(Generator):
    def __init__(self, mix: dict, vocab: int, seed: int):
        super().__init__(mix, vocab, seed)
        fixed = rng(mix["size_seed"])
        self.block = int(mix["block"])
        sp = mix["system_prompts"]
        w = 1.0 / np.arange(1, sp["count"] + 1) ** sp["zipf"]
        self.sizes = np.stack([
            fixed.choice(sp["count"], self.block, p=w / w.sum()),
            lengths(mix["user_tokens"], self.block, fixed),
            lengths(mix["output_tokens"], self.block, fixed),
        ], axis=1)
        sys_rng = rng(self.seed, 1)
        self.system = [sys_rng.integers(0, vocab, sp["tokens"]).astype(np.int32)
                       for _ in range(sp["count"])]

    def request(self, k: int):
        b, j = divmod(k, self.block)
        order = rng(self.seed, 3, b).permutation(self.block)
        sys_i, n_user, n_out = (int(v) for v in self.sizes[order[j]])
        user = self.tokens(n_user, rng(self.seed, 4, k), k)
        return np.concatenate([self.system[sys_i], user]), n_out

    def prompt_range(self):
        n = int(self.mix["system_prompts"]["tokens"])
        return (n + int(self.mix["user_tokens"]["min"]), n + int(self.mix["user_tokens"]["max"]))
