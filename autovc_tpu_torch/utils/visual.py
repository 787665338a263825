"""Figure helpers (counterpart of ``autovc_tpu/utils/visual.py``): the mel
comparison plot and the speaker-embedding TSNE, numpy in and a matplotlib
figure out.

The reference's observability figures: original-vs-reconstruction mel
plots (auto_encoder/model.py:439-450) and the speaker-embedding TSNE
scatter (speaker_encoder/model.py:426-444).  matplotlib and scikit-learn
are optional: they are imported inside the functions, which raise
``ImportError`` where they are missing.
"""
from __future__ import annotations

import numpy as np


def plot_conversion(original: np.ndarray, converted: np.ndarray):
    """Side-by-side mel comparison figure ((n_mels, T) each)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(ncols=2, figsize=(20, 10))
    ax[0].matshow(np.asarray(original))
    ax[0].set_title("Original")
    ax[1].matshow(np.asarray(converted))
    ax[1].set_title("Reconstructed")
    return fig


def visualise_embedding(embeddings: np.ndarray):
    """TSNE scatter of GE2E embeddings, one colour per speaker.

    Args:
      embeddings: (n_speakers, n_utterances, emb).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    embeddings = np.asarray(embeddings)
    S, U, E = embeddings.shape
    flat = embeddings.reshape(S * U, E)
    perplexity = max(2, min(30, S * U - 1))
    X = TSNE(n_components=2, perplexity=perplexity).fit_transform(flat)

    fig, ax = plt.subplots(figsize=(10, 10))
    for s in range(S):
        ax.scatter(X[s * U:(s + 1) * U, 0], X[s * U:(s + 1) * U, 1],
                   alpha=0.6, zorder=3, label=f"speaker {s}")
    ax.grid(ls="--")
    ax.legend()
    return fig
