"""Document QA: each request is a document, then a question about it.

Keys: lengths `doc_tokens`, `question_tokens` and `output_tokens`; each
document is asked `asks_per_doc` times, and the asks of `docs_per_group`
documents are shuffled among each other (so a document's asks fall close
together in the stream); `token_zipf` (the questions' tokens), `block`
(documents a block of fixed sizes) and `size_seed`. Every seed serves the
same set of sizes: drawn once from `size_seed`, permuted by the seed within
every block. A document's tokens are uniform over the vocabulary."""
import numpy as np

from mix import Generator, lengths, rng


class Traffic(Generator):
    def __init__(self, mix: dict, vocab: int, seed: int):
        super().__init__(mix, vocab, seed)
        fixed = rng(mix["size_seed"])
        self.block = int(mix["block"])
        a = int(mix["asks_per_doc"])
        self.doc_len = lengths(mix["doc_tokens"], self.block, fixed)
        self.ask_len = np.stack([lengths(mix["question_tokens"], self.block * a, fixed),
                                 lengths(mix["output_tokens"], self.block * a, fixed)],
                                axis=1).reshape(self.block, a, 2)

    def request(self, k: int):
        a, g = int(self.mix["asks_per_doc"]), int(self.mix["docs_per_group"])
        per_group = a * g
        grp, w = divmod(k, per_group)
        ask_order = rng(self.seed, 5, grp).permutation(per_group)
        doc = grp * g + int(ask_order[w]) // a
        ask = int(ask_order[w]) % a
        db, dj = divmod(doc, self.block)
        slot = int(rng(self.seed, 6, db).permutation(self.block)[dj])
        doc_tokens = rng(self.seed, 7, doc).integers(0, self.vocab, int(self.doc_len[slot]))
        n_q, n_out = (int(v) for v in self.ask_len[slot, ask])
        question = self.tokens(n_q, rng(self.seed, 8, doc, ask), k)
        return np.concatenate([doc_tokens.astype(np.int32), question]), n_out

    def prompt_range(self):
        d, q = self.mix["doc_tokens"], self.mix["question_tokens"]
        return int(d["min"]) + int(q["min"]), int(d["max"]) + int(q["max"])
