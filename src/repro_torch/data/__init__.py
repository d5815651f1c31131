from repro_torch.data.pipeline import (
    DataConfig,
    FileCorpus,
    SyntheticCorpus,
    add_frames,
    make_corpus,
)

__all__ = ["DataConfig", "FileCorpus", "SyntheticCorpus", "add_frames", "make_corpus"]
