"""AdaptiveClassifier — building, growing and serving a classifier.

Counterpart of ``adaptive_classifier_tpu/classifier.py`` for the main path:
``add_examples`` with linear (ridge) heads — the first batch and later
batches with new classes — ``load``, ``predict_batch``, ``predict`` and
``predict_proba``.  Texts are tokenized (and, with the lexical channel on,
hashed into TF-IDF features) on the host; the encoder forward, channel
composition, prototype similarities, head logits and fusion run on the
device, and one packed ``[N, 2k]`` block of scores and ids comes back per
predict call.  ``add_examples`` fits the ridge head in closed form, the
lexical knobs, λ and the fusion share by train-fold probes, and after new
classes the prototype recalibration bias, as the JAX package does.

MLP heads and gradient training, typo-augmented heads, strategic mode,
calibrated probabilities, the embedding cache (``embedding_cache_size`` is
read and ignored), saving and the other surfaces come with later slices.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from .config import ModelConfig
from . import training
from .memory import PrototypeMemory, gather_training_set
from .models import head as head_lib
from .models.encoder import Encoder
from .models.head import HeadParams
from .ops import fusion

Predictions = List[List[Tuple[str, float]]]


class AdaptiveClassifier:
    """A saved adaptive classifier, served from PyTorch.

    ``device`` defaults to ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    ``config={"quantization": "int8"}`` runs the encoder's int8 forward.
    ``model_name`` is a local checkpoint directory, or a BERT model name
    (``"bert-base-uncased"``, ``"prajjwal1/bert-tiny"``, ...) built offline
    with random weights.
    """

    def __init__(
        self,
        model_name: str,
        device: Optional[Union[str, torch.device]] = None,
        config: Optional[Dict[str, Any]] = None,
        seed: int = 42,
        encoder: Optional[Encoder] = None,
    ):
        self.config = ModelConfig(config)
        if self.config.enable_strategic_mode:
            raise NotImplementedError("strategic mode comes with a later slice")
        self.model_name = model_name
        self.seed = seed
        self.device = resolve_device(device)
        #: ``encoder``: one built elsewhere (a checkpoint's int8 export); a
        #: model name with no local checkpoint builds its offline random
        #: weights from ``seed``, as the JAX package does
        self.encoder = encoder if encoder is not None else Encoder(
            model_name, compute_dtype=self.config.compute_dtype, device=self.device,
            quantization=self.config.quantization, seed=seed)
        #: hashed TF-IDF lexical channel; None = encoder embedding only
        self.lexical = None
        if self.config.lexical_dim:
            from .lexical import HashedTfidf

            self.lexical = HashedTfidf(self.config.lexical_dim,
                                       self.config.lexical_weight,
                                       self.config.lexical_grams)
        self.embedding_dim = self.encoder.hidden_size + (
            self.lexical.dim if self.lexical is not None else 0)
        self.memory = PrototypeMemory(self.embedding_dim, config=self.config,
                                      device=self.device)
        self.head_params: Optional[HeadParams] = None
        self.label_to_id: Dict[str, int] = {}
        self.id_to_label: Dict[int, str] = {}
        self.train_steps = 0
        self.training_history: Dict[str, int] = {}
        #: per-class prototype bias from incremental training; None = none
        self._proto_bias: Optional[np.ndarray] = None
        #: fitted prototype share of the fusion; None = reference weighting
        self._fusion_alpha: Optional[float] = None

    @classmethod
    def load(cls, save_dir: Union[str, Path],
             device: Optional[Union[str, torch.device]] = None) -> "AdaptiveClassifier":
        from . import persistence

        return persistence.load_classifier(cls, Path(save_dir), device=device)

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------
    def _tokenize_chunk(self, part: List[str], pad_to: int):
        """→ (ids, mask, lex) for ``part`` padded with empty texts to
        ``pad_to`` rows; ``lex`` is None with the lexical channel off."""
        padded = list(part) + [""] * (max(pad_to, len(part)) - len(part))
        ids, mask = self.encoder.tokenizer(
            padded, max_length=self.config.max_length,
            pad_to_buckets=self.encoder.SEQ_BUCKETS)
        lex = None
        if self.lexical is not None:
            if not self.lexical.ready:
                raise RuntimeError(
                    "lexical channel not ready: its IDF table, gram kind and "
                    "weight are fitted on the first add_examples() batch or "
                    "loaded with a checkpoint")
            lex = self.lexical.transform(padded)
        return ids, mask, lex

    def _chunk_size(self, override: Optional[int] = None) -> int:
        return max(override, 1) if override else max(self.config.embed_chunk_size, 64)

    @staticmethod
    def _pad_rows(n: int, chunk: int) -> int:
        """Batch buckets {1, 8, 64, chunk}: the device sees few shapes."""
        return 1 if n == 1 else 8 if n <= 8 else 64 if n <= 64 else chunk

    def _embed_chunks(self, texts: List[str], chunk_override: Optional[int] = None
                      ) -> Iterator[Tuple[torch.Tensor, int]]:
        """``(emb [pad, D] on the device, n real rows)`` per chunk."""
        CH = self._chunk_size(chunk_override)
        for s in range(0, len(texts), CH):
            part = texts[s:s + CH]
            ids, mask, lex = self._tokenize_chunk(part, self._pad_rows(len(part), CH))
            yield self._compose_channels(self.encoder.embed_ids(ids, mask), lex), len(part)

    def _get_embeddings(self, texts: List[str]) -> np.ndarray:
        """Embeddings of ``texts`` on the host ``[N, D]`` float32 (the JAX
        package's embedding cache is not ported: every call embeds)."""
        with torch.inference_mode():
            parts = [emb[:n] for emb, n in self._embed_chunks(texts)]
            return torch.cat(parts, dim=0).float().cpu().numpy()

    def _compose_channels(self, enc: torch.Tensor, lex: Optional[np.ndarray]) -> torch.Tensor:
        """``[enc, w*lex] / sqrt(1+w²)`` on the device; identity without lex."""
        if lex is None:
            return enc
        w = float(self.lexical.weight)
        s = 1.0 / math.sqrt(1.0 + w * w)
        lex_t = torch.from_numpy(lex).to(enc.device, non_blocking=True)
        return torch.cat([enc * s, lex_t * (w * s)], dim=1)

    # ------------------------------------------------------------------
    # masks / weights
    # ------------------------------------------------------------------
    @property
    def _class_capacity(self) -> int:
        return self.memory.state.class_capacity

    def _active_mask(self) -> torch.Tensor:
        return torch.arange(self._class_capacity, device=self.device) < len(self.label_to_id)

    def _history_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-label fusion weights: a fitted fusion share applies uniformly;
        otherwise <10 trained examples → proto 0.3 / head 0.7, else 0.7/0.3."""
        C = self._class_capacity
        if self._fusion_alpha is not None:
            pw = np.full((C,), self._fusion_alpha, np.float32)
        else:
            pw = np.full((C,), 0.3, np.float32)
            for label, idx in self.label_to_id.items():
                pw[idx] = 0.3 if self.training_history.get(label, 0) < 10 else 0.7
        pw_t = torch.from_numpy(pw).to(self.device)
        return pw_t, 1.0 - pw_t

    def _proto_bias_arr(self) -> Optional[torch.Tensor]:
        """Calibration bias padded to the class capacity (or None)."""
        if self._proto_bias is None:
            return None
        b = np.zeros((self._class_capacity,), np.float32)
        n = min(len(self._proto_bias), b.shape[0])
        b[:n] = self._proto_bias[:n]
        return torch.from_numpy(b).to(self.device)

    # ------------------------------------------------------------------
    # add_examples
    # ------------------------------------------------------------------
    def _check_trainable(self, labels: List[str]):
        """Raise for the training paths that come with later slices, before
        anything is changed."""
        if self.config.head_type != "ridge":
            raise NotImplementedError(
                f"head_type={self.config.head_type!r}: MLP heads and gradient "
                f"training come with a later slice; use head_type='ridge'")
        if self.config.head_typo_augment:
            raise NotImplementedError("head_typo_augment comes with a later slice")
        if set(labels) - set(self.label_to_id) and self._lossy_replay():
            raise self._lossy_replay_error()

    def _lossy_replay(self, exclude: Set[str] = frozenset()) -> bool:
        """Whether some stored class trained on more examples than the store
        keeps (a loaded checkpoint keeps ~5 rows per class) while the config
        asks to freeze old classes for new ones."""
        return (self.head_params is not None
                and self.config.incremental_freeze_on_lossy_replay
                and any(self.training_history.get(l, 0) > len(t)
                        for l, t in self.memory.texts.items() if t and l not in exclude))

    @staticmethod
    def _lossy_replay_error() -> NotImplementedError:
        return NotImplementedError(
            "new classes on a lossy replay store (a loaded checkpoint keeps "
            "~5 rows per class) train frozen old classes by gradient descent, "
            "which comes with a later slice")

    def add_examples(self, texts: List[str], labels: List[str]):
        """Store labeled examples and refit: new labels get ids in
        alphabetical order, the prototypes take the new embeddings, and the
        ridge head is refitted on every stored example.  After new classes
        on a classifier that has some, the prototype recalibration bias is
        fitted too."""
        if not texts or not labels:
            raise ValueError("Empty input lists")
        if len(texts) != len(labels):
            raise ValueError("Mismatched text and label lists")
        self._check_trainable(labels)

        self._ensure_lexical_ready(texts, labels)

        has_existing_classes = len(self.label_to_id) > 0
        new_classes = set(labels) - set(self.label_to_id)
        for label in sorted(new_classes):
            idx = len(self.label_to_id)
            self.label_to_id[label] = idx
            self.id_to_label[idx] = label
            self.memory.register_label(label)

        embeddings = self._get_embeddings(texts)
        self.memory.add_batch_host(texts, embeddings, labels)
        for label in labels:
            self.training_history[label] = self.training_history.get(label, 0) + 1

        if new_classes and has_existing_classes:
            old_head = self.head_params
            self._ensure_head_capacity()
            self._train_new_classes(old_head, new_classes)
            if self.config.prototype_recalibration:
                self._recalibrate_prototypes(new_classes)
        else:
            if self.head_params is None:
                self._initialize_adaptive_head()
            elif new_classes:
                self._ensure_head_capacity()
            self._train_adaptive_head()

    @staticmethod
    def _typo_variant(text: str, seed: int) -> str:
        """Deterministic per-text corruption keyed on ``(seed, text)``:
        adjacent-character swap per word of ≥4 chars with p=0.6, plus a
        hedging-filler suffix."""
        import random as _random

        rng = _random.Random(f"{seed}:{text}")
        words = text.split(" ")
        for i, w in enumerate(words):
            if len(w) >= 4 and rng.random() < 0.6:
                j = rng.randrange(1, len(w) - 2)
                words[i] = w[:j] + w[j + 1] + w[j] + w[j + 2:]
        return (" ".join(words) + " , "
                + rng.choice(AdaptiveClassifier._AUG_FILLERS))

    #: hedging fillers of the typo'd views
    _AUG_FILLERS = ("all things considered", "to be fair",
                    "generally speaking", "as far as i can tell",
                    "if you ask me")

    def _ensure_lexical_ready(self, texts: List[str], labels: List[str]):
        """First-batch lexical setup (no-op afterwards): resolve
        ``grams="auto"`` / ``weight="auto"`` by the train-fold ridge-probe
        sweep and fit the IDF table.  A single-class first batch cannot be
        swept: word grams at w=1.0."""
        if self.lexical is None or self.lexical.ready:
            return
        uniq = sorted(set(labels))
        if len(uniq) < 2:
            if self.lexical.grams == "auto":
                self.lexical.grams = "word"
            if isinstance(self.lexical.weight, str):
                self.lexical.weight = 1.0
            if not self.lexical.fitted:
                self.lexical.fit(texts)
        elif (self.lexical.grams != "auto"
              and not isinstance(self.lexical.weight, str)):
            self.lexical.fit(texts)
        else:
            # dense encoder channel only (composition needs the weight)
            saved, self.lexical = self.lexical, None
            try:
                enc = self._get_embeddings(texts)
                typo_views = None
                if saved.grams == "auto":
                    # robust tie-breaking among near-tied gram kinds
                    texts_t = [self._typo_variant(t, self.seed) for t in texts]
                    typo_views = (self._get_embeddings(texts_t), texts_t)
            finally:
                self.lexical = saved
            lid = {l: i for i, l in enumerate(uniq)}
            self.lexical.resolve_config(enc, texts, [lid[l] for l in labels],
                                        typo_views=typo_views)

    def _initialize_adaptive_head(self):
        """A linear head over the class capacity (ridge heads have no hidden
        layers); the ridge fit that follows sets its weights."""
        self.head_params = head_lib.init_head(
            self.embedding_dim, self._class_capacity, hidden_dims=[],
            device=self.device)

    def _ensure_head_capacity(self):
        if self.head_params is None:
            return
        if self.head_params["out"]["w"].shape[1] < self._class_capacity:
            self.head_params = head_lib.grow_capacity(self.head_params,
                                                      self._class_capacity)

    def _train_adaptive_head(self):
        """Closed-form ridge refit on every stored example; λ ``"auto"`` is
        resolved once and stored in the config, then the fusion share is
        fitted when ``fusion_weights="auto"``."""
        n_total = sum(len(t) for t in self.memory.texts.values())
        if n_total == 0 or self.head_params is None:
            return
        n_cap = self.config.train_capacity(n_total)
        emb, lbl, valid = gather_training_set(self.memory.state, n_cap)
        if self.config.ridge_lambda == "auto":
            lam, _ = training.select_ridge_lambda(emb, lbl, valid,
                                                  self._class_capacity)
            self.config.ridge_lambda = lam
        self.head_params = training.ridge_head_params(
            emb, lbl, valid, self._class_capacity,
            lam=self.config.ridge_lambda, keep_from=self.head_params)
        self.train_steps += 1
        if self.config.fusion_weights == "auto":
            self._fit_fusion_alpha(emb, lbl, valid)

    def _fit_fusion_alpha(self, emb, lbl, valid):
        """Fit the prototype/head fusion share on a 2-fold split of the
        training rows; each fold fits a ridge head on its fit half and is
        scored on its val half (training.fit_fusion_alpha)."""
        n = int(valid.sum())
        n_classes = len(self.label_to_id)
        if n < 8 or n_classes < 2:
            return
        e = emb[:n].float().cpu().numpy()      # valid rows are front-sorted
        y = lbl[:n].cpu().numpy()
        cap = self._class_capacity
        lam = self.config.ridge_lambda
        dev = self.device

        def fold_fit(fe, fy, ve):
            nf = len(fy)
            fcap = self.config.train_capacity(nf)
            fe_p = torch.zeros((fcap, fe.shape[1]), device=dev)
            fy_p = torch.zeros((fcap,), dtype=torch.int64, device=dev)
            fe_p[:nf] = torch.from_numpy(fe).to(dev)
            fy_p[:nf] = torch.from_numpy(fy.astype(np.int64)).to(dev)
            W = training.ridge_solve(fe_p, fy_p, torch.arange(fcap, device=dev) < nf,
                                     cap, lam)
            return (torch.from_numpy(np.ascontiguousarray(ve)).to(dev) @ W).cpu().numpy()

        self._fusion_alpha, _ = training.fit_fusion_alpha(e, y, n_classes, fold_fit)

    def _train_new_classes(self, old_head: Optional[HeadParams], new_classes: Set[str]):
        """New classes on a classifier that has some: a ridge head is refitted
        on the whole replay store.  After a lossy load (fewer stored rows
        than the class trained on) the JAX package instead freezes the old
        classes and trains only the new output rows by gradient descent;
        that path comes with a later slice."""
        if not any(self.memory.texts.values()):
            return
        if self.head_params is None:
            self._initialize_adaptive_head()
        if old_head is not None and self._lossy_replay(exclude=new_classes):
            raise self._lossy_replay_error()
        self._train_adaptive_head()

    def _recalibrate_prototypes(self, new_classes: Set[str]):
        """Fit the per-class similarity penalty of the just-added classes on
        the replay store (training.fit_new_class_penalty), on top of any
        earlier bias."""
        n_total = sum(len(t) for t in self.memory.texts.values())
        if n_total < 2 or len(self.label_to_id) < 2 or not new_classes:
            return
        n_cap = self.config.train_capacity(n_total)
        emb, lbl, valid = gather_training_set(self.memory.state, n_cap)
        sims = self.memory.sims_for(emb)
        prev = self._proto_bias_arr()
        if prev is not None:
            sims = sims + prev[None, :]
        new_ids = [self.label_to_id[c] for c in new_classes]
        bias = training.fit_new_class_penalty(
            sims, lbl, valid, self.memory.state.valid, new_ids).cpu().numpy()
        if prev is not None:
            bias = bias + prev.cpu().numpy()
        self._proto_bias = bias.astype(np.float32)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def predict(self, text: str, k: int = 5) -> List[Tuple[str, float]]:
        """Top-k labels for one text, with the full-distribution fusion of
        the JAX package's ``predict`` (per-label history weights)."""
        if not text:
            raise ValueError("Empty input text")
        if not self.label_to_id:
            return []
        pw, hw = self._history_weights()
        kk = min(max(k, 1), self._class_capacity)
        state = self.memory.state
        active = self._active_mask()
        proto_bias = self._proto_bias_arr()
        has_head = self.head_params is not None

        def fuse(emb):
            return fusion.fuse_full_from_emb(
                emb, state.proto, state.valid, self.head_params, active, pw, hw,
                kk, has_head, pallas_min_classes=self.config.pallas_knn_min_classes,
                proto_bias=proto_bias)

        return self._predict_rows([text], fuse, kk, k)[0]

    def predict_batch(self, texts: List[str], k: int = 5,
                      batch_size: Optional[int] = None) -> Predictions:
        """Top-k labels per text: prototype top-k fused with the head's top-k
        at a fixed prototype share (the fitted one, else 0.7).

        ``batch_size`` caps the rows per device chunk (default
        ``config.embed_chunk_size``)."""
        if not texts:
            raise ValueError("Empty input batch")
        if not self.label_to_id:
            return [[] for _ in texts]
        kk = min(max(k, 1), self._class_capacity)
        state = self.memory.state
        active = self._active_mask()
        proto_bias = self._proto_bias_arr()
        pw = 0.7 if self._fusion_alpha is None else float(self._fusion_alpha)
        has_head = self.head_params is not None

        def fuse(emb):
            return fusion.fuse_topk_from_emb(
                emb, state.proto, state.valid, self.head_params, active,
                pw, 1.0 - pw, kk, has_head,
                pallas_min_classes=self.config.pallas_knn_min_classes,
                proto_bias=proto_bias,
                fused_min_classes=self.config.fused_topk_min_classes)

        return self._predict_rows(texts, fuse, kk, k, chunk_override=batch_size)

    def _predict_rows(self, texts: List[str],
                      fuse: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
                      kk: int, k: int,
                      chunk_override: Optional[int] = None) -> Predictions:
        """Shared predict pipeline.  Chunks are padded to the batch buckets
        {1, 8, 64, chunk} so the device sees few shapes; each chunk's
        ``[pad, 2·kk]`` block of scores and ids stays on the device until one
        copy to the host at the end, and no step in between waits for the
        device, so the host tokenizes chunk N+1 while the device runs N."""
        packed, spans = [], []
        with torch.inference_mode():
            for emb, n in self._embed_chunks(texts, chunk_override):
                scores, idx = fuse(emb)
                packed.append(torch.cat([scores, idx.float()], dim=1))
                spans.append((n, scores.shape[0]))
            host = torch.cat(packed, dim=0).cpu().numpy()
        keep = np.zeros(host.shape[0], bool)
        off = 0
        for n, pad in spans:
            keep[off:off + n] = True
            off += pad
        host = host[keep]
        id2l = self.id_to_label
        return [
            [(id2l[i], s) for s, i in zip(srow, irow) if i >= 0 and i in id2l][:k]
            for srow, irow in zip(host[:, :kk].tolist(),
                                  host[:, kk:].astype(np.int64).tolist())
        ]

    def predict_proba(self, texts: Union[str, List[str]], calibrated: bool = False
                      ) -> Tuple[np.ndarray, List[str]]:
        """Full fused probability distribution per text → ``(probs
        [N, n_classes], labels)``: the per-label-weight fusion of
        ``predict``, returned whole; rows sum to 1."""
        if calibrated:
            raise NotImplementedError("calibrated probabilities (calibrate(), "
                                      "temperature scaling) come with a later slice")
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            raise ValueError("Empty input batch")
        n_classes = len(self.label_to_id)
        labels = [self.id_to_label[i] for i in range(n_classes)]
        if n_classes == 0:
            return np.zeros((len(texts), 0), np.float32), labels
        state = self.memory.state
        active = self._active_mask()
        pw, hw = self._history_weights()
        proto_bias = self._proto_bias_arr()
        parts = []
        with torch.inference_mode():
            for emb, n in self._embed_chunks(texts):
                parts.append(fusion.fuse_dist_from_emb(
                    emb, state.proto, state.valid, self.head_params, active,
                    pw, hw, self.head_params is not None,
                    pallas_min_classes=self.config.pallas_knn_min_classes,
                    proto_bias=proto_bias)[:n])
            probs = torch.cat(parts, dim=0).cpu().numpy()
        return probs[:, :n_classes], labels
