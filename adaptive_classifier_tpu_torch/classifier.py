"""AdaptiveClassifier — building, growing and serving a classifier.

Counterpart of ``adaptive_classifier_tpu/classifier.py``: ``add_examples``
with ridge and MLP heads (the first batch, and later batches with new
classes), ``save``, ``load`` and ``from_pretrained`` (a local directory),
``predict_batch``, ``predict``, ``predict_proba`` (temperature-calibrated
after ``calibrate``), ``predict_document`` for texts longer than the
encoder window, the robust / strategic entry points (which answer as
``predict`` does: strategic mode is not ported), and the memory's editing
surface (``clear_memory``, ``merge_classifiers``).  Texts are tokenized
(and, with the lexical channel on, hashed into TF-IDF features) on the
host; the encoder forward, channel composition, prototype similarities,
head logits and fusion run on the device, and one packed ``[N, 2k]`` block
of scores and ids comes back per predict call.  A text seen before is not
embedded again: ``_get_embeddings`` reads a host LRU, and the predict path
a ring buffer of rows on the device (``utils/cache.py``), both sized by
``embedding_cache_size``.  ``add_examples`` fits a ridge head in closed
form and an MLP head by gradient descent (``training.fit_head``); the
lexical knobs, λ and the fusion share by train-fold probes; new classes on
a trained classifier by balanced replay with EWC and distillation, or,
after a lossy load, as frozen-trunk probes; and the prototype
recalibration bias, as the JAX package does.  Random draws (head init,
shuffles, dropout, EWC sampling, k-means) come from ``torch.Generator``s
on the classifier's device, seeded from the classifier's seed and the JAX
package's salt for each fit.

Methods may be called from several threads at once (the serving workers
do): the caches and the memory take their own locks, and every launch goes
to the device's current stream, whose order keeps a cache row's write
ahead of any gather of it.  ``add_examples`` must not run beside a predict
(the server's reader-writer lock sees to it).
"""

from __future__ import annotations

import contextlib
import math
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from . import ewc as ewc_lib
from . import training
from ._device import resolve_device
from .config import Example, ModelConfig
from .memory import PrototypeMemory, gather_training_set
from .models import head as head_lib
from .models.encoder import Encoder
from .models.head import HeadParams
from .ops import fusion, kmeans

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
        #: the last gradient fit's result (params, final loss, epochs run)
        self.last_fit: Optional[training.TrainResult] = None
        #: generators handed out by _next_generator (the EWC draws)
        self._draws = 0
        #: stage timers (enable_profiling); None = off
        self.timers = None
        #: fitted calibration.TemperatureScaler; None until calibrate()
        self._temperature_scaler = None
        #: the host LRU (_get_embeddings) and the device ring (the predict
        #: path), made at first use when embedding_cache_size > 0
        self._emb_cache = None
        self._dev_cache = None
        self._cache_lock = threading.Lock()

    @classmethod
    def load(cls, save_dir: Union[str, Path],
             device: Optional[Union[str, torch.device]] = None) -> "AdaptiveClassifier":
        from . import persistence

        return persistence.load_classifier(cls, Path(save_dir), device=device)

    @classmethod
    def from_pretrained(cls, model_id: Union[str, Path],
                        device: Optional[Union[str, torch.device]] = None
                        ) -> "AdaptiveClassifier":
        """A checkpoint in a local directory; anything else raises (the
        JAX package's Hub download is not ported)."""
        from . import persistence

        return persistence.from_pretrained(cls, model_id, device=device)

    def to(self, device: Union[str, torch.device]) -> "AdaptiveClassifier":
        """``self`` for the classifier's own device; moving the state to
        another device is not ported yet."""
        dev = torch.device(device)
        if dev.type == self.device.type and (
                dev.index is None or self.device.index is None
                or dev.index == self.device.index):
            return self
        raise NotImplementedError(
            f"moving a classifier from {self.device} to {dev} comes with a later "
            f"slice; load the checkpoint with device={str(dev)!r} instead")

    @property
    def strategic_mode(self) -> bool:
        """Always false: the constructor refuses ``enable_strategic_mode``."""
        return False

    def enable_profiling(self):
        """Attach stage timers (``tokenize``, ``encoder_forward``,
        ``knn_fusion``) → the ``StageTimers``, for ``summary()`` and
        ``report()``."""
        from .utils.profiling import StageTimers

        self.timers = StageTimers()
        return self.timers

    def _stage(self, name: str):
        return self.timers.stage(name) if self.timers is not None else contextlib.nullcontext()

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
            with self._stage("tokenize"):
                ids, mask, lex = self._tokenize_chunk(part, self._pad_rows(len(part), CH))
            with self._stage("encoder_forward"):
                emb = self._compose_channels(self.encoder.embed_ids(ids, mask), lex)
            yield emb, len(part)

    def _query_chunks(self, texts: List[str], chunk_override: Optional[int] = None
                      ) -> Iterator[Tuple[torch.Tensor, int]]:
        """The chunks a prediction scores: ``_embed_chunks``, or, when
        ``_get_embeddings`` was replaced on the instance or in a subclass
        (the reference's extension point), its rows."""
        if not self._embeddings_overridden():
            yield from self._embed_chunks(texts, chunk_override)
            return
        CH = self._chunk_size(chunk_override)
        for s in range(0, len(texts), CH):
            part = texts[s:s + CH]
            rows = np.asarray(self._get_embeddings(part), np.float32)
            yield torch.from_numpy(rows).to(self.device), len(part)

    def _embeddings_overridden(self) -> bool:
        return ("_get_embeddings" in self.__dict__
                or type(self)._get_embeddings is not AdaptiveClassifier._get_embeddings)

    def _get_embeddings(self, texts: List[str]) -> np.ndarray:
        """Embeddings of ``texts`` on the host ``[N, D]`` float32.  Texts
        seen before come from the host LRU (``embedding_cache_size`` rows;
        0 turns it off); the others are embedded and stored."""
        cache = self._host_cache()
        if cache is None:
            return self._embed_uncached(texts)
        cached, miss_idx = cache.lookup(texts, self.config.max_length)
        if not miss_idx:
            return (np.stack(cached) if cached
                    else np.zeros((0, self.embedding_dim), np.float32))
        miss_texts = [texts[i] for i in miss_idx]
        fresh = self._embed_uncached(miss_texts)
        cache.store(miss_texts, self.config.max_length, fresh)
        out = np.zeros((len(texts), self.embedding_dim), np.float32)
        out[miss_idx] = fresh
        for i, row in enumerate(cached):
            if row is not None:
                out[i] = row
        return out

    def _embed_uncached(self, texts: List[str]) -> np.ndarray:
        with torch.inference_mode():
            parts = [emb[:n] for emb, n in self._embed_chunks(texts)]
            return torch.cat(parts, dim=0).float().cpu().numpy()

    def _embed_device(self, texts: List[str]) -> torch.Tensor:
        return torch.from_numpy(self._get_embeddings(texts)).to(self.device)

    def _host_cache(self):
        if self._emb_cache is None and self.config.embedding_cache_size > 0:
            from .utils.cache import EmbeddingCache

            with self._cache_lock:
                if self._emb_cache is None:
                    self._emb_cache = EmbeddingCache(self.config.embedding_cache_size)
        return self._emb_cache

    def _device_cache(self):
        """The device ring, made at the first predict (at the production
        width it is 4,096 x 33,280 float32 rows, 545 MB).  Call it outside
        ``torch.inference_mode()``."""
        if self._dev_cache is None and self.config.embedding_cache_size > 0:
            from .utils.cache import DeviceEmbeddingCache

            with self._cache_lock:
                if self._dev_cache is None:
                    self._dev_cache = DeviceEmbeddingCache(
                        self.config.embedding_cache_size, self.embedding_dim, self.device)
        return self._dev_cache

    def _clear_embedding_caches(self):
        """Forget every cached row, host and device: the next predict of a
        text embeds it again."""
        for cache in (self._emb_cache, self._dev_cache):
            if cache is not None:
                cache.clear()

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

    def _head_logits(self, emb: torch.Tensor) -> torch.Tensor:
        if self.head_params is None:
            return torch.zeros((emb.shape[0], self._class_capacity), device=emb.device)
        return head_lib.head_forward(self.head_params, emb)

    # ------------------------------------------------------------------
    # random draws
    # ------------------------------------------------------------------
    def _generator(self, *salt: int) -> torch.Generator:
        """A generator on the classifier's device seeded from ``(seed,
        *salt)``: the JAX package's ``PRNGKey(seed)`` with no salt, its
        ``fold_in(PRNGKey(seed), salt)`` with one, so each fit's draws do not
        depend on what ran before it."""
        state = np.random.SeedSequence([self.seed % 2**64, *salt]).generate_state(1, np.uint64)
        return torch.Generator(device=self.device).manual_seed(int(state[0]))

    def _next_generator(self) -> torch.Generator:
        """The next generator of the classifier's own stream (the JAX
        package's ``_next_key``), restarted by a load."""
        self._draws += 1
        return self._generator(0x5EED, self._draws)

    # ------------------------------------------------------------------
    # add_examples
    # ------------------------------------------------------------------
    def add_examples(self, texts: List[str], labels: List[str]):
        """Store labeled examples and refit: new labels get ids in
        alphabetical order, the prototypes take the new embeddings, and the
        head is refitted on the stored examples (``_train_adaptive_head``),
        or, for new classes on a classifier that has some, trained for them
        (``_train_new_classes``) and the prototype recalibration bias
        fitted."""
        if not texts or not labels:
            raise ValueError("Empty input lists")
        if len(texts) != len(labels):
            raise ValueError("Mismatched text and label lists")

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
                enc = self._embed_uncached(texts)
                typo_views = None
                if saved.grams == "auto":
                    # robust tie-breaking among near-tied gram kinds
                    texts_t = [self._typo_variant(t, self.seed) for t in texts]
                    typo_views = (self._embed_uncached(texts_t), texts_t)
            finally:
                self.lexical = saved
            lid = {l: i for i, l in enumerate(uniq)}
            self.lexical.resolve_config(enc, texts, [lid[l] for l in labels],
                                        typo_views=typo_views)
        # no row embedded before the channel was set up may be served
        self._emb_cache = None

    def _initialize_adaptive_head(self):
        """Hidden layers ``[D, D//2]`` at the dense encoder width ``D``
        (also with the lexical channel on), none for ``head_type="ridge"``,
        whose closed-form fit overwrites the output layer."""
        D = self.encoder.hidden_size
        hidden = [] if self.config.head_type == "ridge" else [D, D // 2]
        self.head_params = head_lib.init_head(
            self.embedding_dim, self._class_capacity, max(len(self.label_to_id), 1),
            hidden_dims=hidden, generator=self._generator())

    def _ensure_head_capacity(self):
        """Repad the output layer when the class capacity crossed a bucket."""
        if self.head_params is None:
            return
        if self.head_params["out"]["w"].shape[1] < self._class_capacity:
            self.head_params = head_lib.grow_capacity(
                self.head_params, self._class_capacity, self._generator(),
                len(self.label_to_id))

    def _train_adaptive_head(self):
        """Refit on every stored example: a ridge head in closed form (λ
        ``"auto"`` resolved once on the clean rows and stored in the
        config), an MLP head by ``training.fit_head``; with
        ``head_typo_augment`` on typo'd copies of the rows as well.  Then
        the fusion share is fitted on the clean rows when
        ``fusion_weights="auto"``."""
        n_total = sum(len(t) for t in self.memory.texts.values())
        if n_total == 0 or self.head_params is None:
            return
        n_cap = self.config.train_capacity(n_total)
        emb, lbl, valid = gather_training_set(self.memory.state, n_cap)
        clean_rows = (emb, lbl, valid)
        row_weight = None
        if self.config.head_typo_augment:
            emb, lbl, valid, row_weight = self._typo_augment_rows(emb, lbl, valid)
        if self.config.head_type == "ridge":
            if self.config.ridge_lambda == "auto":
                lam, _ = training.select_ridge_lambda(*clean_rows, self._class_capacity)
                self.config.ridge_lambda = lam
            self.head_params = training.ridge_head_params(
                emb, lbl, valid, self._class_capacity, lam=self.config.ridge_lambda,
                keep_from=self.head_params, sample_weight=row_weight)
        else:
            self.last_fit = training.fit_head(
                self.head_params, emb, lbl, valid, self._active_mask(),
                self._generator(self.train_steps), lr=self.config.learning_rate,
                loss_type="ce", max_epochs=self.config.epochs,
                patience=self.config.early_stopping_patience, use_scheduler=True)
            self.head_params = self.last_fit.params
        self.train_steps += 1
        if self.config.fusion_weights == "auto":
            self._fit_fusion_alpha(*clean_rows)

    def _typo_augment_rows(self, emb, lbl, valid):
        """The training rows plus one typo'd copy per stored text
        (``_typo_variant``) at weight ``head_typo_weight``
        → ``(emb, lbl, valid, row_weight)``; the prototypes never see them."""
        texts: List[str] = []
        labels: List[str] = []
        for label, ts in self.memory.texts.items():
            texts += ts
            labels += [label] * len(ts)
        if not texts:
            return emb, lbl, valid, None
        aug_texts = [self._typo_variant(t, self.seed) for t in texts]
        dev = emb.device
        aug_emb = torch.from_numpy(self._get_embeddings(aug_texts)).to(dev)
        aug_ids = torch.tensor([self.label_to_id[l] for l in labels],
                               dtype=lbl.dtype, device=dev)
        n, m = int(valid.sum()), len(aug_texts)
        cap2 = self.config.train_capacity(n + m)
        e2 = torch.zeros((cap2, emb.shape[1]), device=dev)
        e2[:n], e2[n:n + m] = emb[:n], aug_emb
        l2 = torch.zeros((cap2,), dtype=lbl.dtype, device=dev)
        l2[:n], l2[n:n + m] = lbl[:n], aug_ids
        w2 = torch.ones((cap2,), device=dev)
        w2[n:n + m] = self.config.head_typo_weight
        return e2, l2, torch.arange(cap2, device=dev) < (n + m), w2

    def _fit_fusion_alpha(self, emb, lbl, valid):
        """Fit the prototype/head fusion share on a 2-fold split of the
        training rows; each fold fits a head of the configured type on its
        fit half (ridge in closed form, MLP by the same gradient fit from
        the same init) and is scored on its val half
        (training.fit_fusion_alpha)."""
        n = int(valid.sum())
        n_classes = len(self.label_to_id)
        if n < 8 or n_classes < 2:
            return
        e = emb[:n].float().cpu().numpy()      # valid rows are front-sorted
        y = lbl[:n].cpu().numpy()
        cap = self._class_capacity
        dev = self.device

        def padded(fe, fy):
            nf = len(fy)
            fcap = self.config.train_capacity(nf)
            fe_p = torch.zeros((fcap, fe.shape[1]), device=dev)
            fy_p = torch.zeros((fcap,), dtype=torch.int64, device=dev)
            fe_p[:nf] = torch.from_numpy(fe).to(dev)
            fy_p[:nf] = torch.from_numpy(fy.astype(np.int64)).to(dev)
            return fe_p, fy_p, torch.arange(fcap, device=dev) < nf

        def ve_t(ve):
            return torch.from_numpy(np.ascontiguousarray(ve)).to(dev)

        if self.config.head_type == "ridge":
            lam = self.config.ridge_lambda

            def fold_fit(fe, fy, ve):
                W = training.ridge_solve(*padded(fe, fy), cap, lam)
                return (ve_t(ve) @ W).cpu().numpy()
        else:
            D = self.encoder.hidden_size

            def fold_fit(fe, fy, ve):
                params = head_lib.init_head(self.embedding_dim, cap, max(n_classes, 1),
                                            hidden_dims=[D, D // 2],
                                            generator=self._generator())
                result = training.fit_head(
                    params, *padded(fe, fy), self._active_mask(), self._generator(104729),
                    lr=self.config.learning_rate, loss_type="ce",
                    max_epochs=self.config.epochs,
                    patience=self.config.early_stopping_patience, use_scheduler=True)
                return head_lib.head_forward(result.params, ve_t(ve)).cpu().numpy()

        self._fusion_alpha, _ = training.fit_fusion_alpha(e, y, n_classes, fold_fit)

    def _train_new_classes(self, old_head: Optional[HeadParams], new_classes: Set[str]):
        """New classes on a classifier that has some.

        A ridge head with its full replay store is refitted in closed form.
        Otherwise the head trains on a class-balanced resample of the store
        (``np.random.default_rng(seed + train_steps)``, as the JAX package
        draws it), with an EWC penalty over at most 5 exemplars per old
        class and logit distillation from the old head.  After a lossy load
        (a class trained on more examples than the store keeps) with
        ``incremental_freeze_on_lossy_replay``, the trunk and the old output
        columns are frozen instead: the new columns and a raw-embedding
        ``skip`` probe train as one-vs-all sigmoid probes, three rows of
        each old prototype anchoring them, so the old classes' logits stay
        bit-identical."""
        counts = {l: len(t) for l, t in self.memory.texts.items() if t}
        if not counts:
            return
        if self.head_params is None:
            self._initialize_adaptive_head()

        rng = np.random.default_rng(self.seed + self.train_steps)
        min_examples = min(counts.values())
        num_classes = len(counts)
        target = max(5, min(10, min_examples * 2))
        sel_slots: List[int] = []
        sel_pos: List[int] = []
        sel_labels: List[int] = []
        for label, n in counts.items():
            slot = self.memory.label_to_index[label]
            if num_classes > 20:  # many-class stratified sampling
                ns = min(n, target * 2) if label in new_classes else min(n, target)
            else:
                weight = 2.0 if label in new_classes else min_examples / n
                ns = max(min_examples, int(n * weight))
            idxs = rng.choice(n, size=ns, replace=ns > n)
            sel_slots += [slot] * len(idxs)
            sel_pos += [int(i) for i in idxs]
            sel_labels += [self.label_to_id[label]] * len(idxs)

        old_labels = [l for l in counts if l not in new_classes]
        lossy_replay = old_head is not None and any(
            self.training_history.get(l, 0) > counts.get(l, 0) for l in old_labels)
        freeze_old = lossy_replay and self.config.incremental_freeze_on_lossy_replay

        if self.config.head_type == "ridge" and not freeze_old:
            # the exact ridge solution weighs every stored row already
            self._train_adaptive_head()
            return

        dev = self.device
        st = self.memory.state
        n_sel = len(sel_labels)
        proto_rows = []
        if freeze_old:
            # the replay rows are the new probes' only negatives: each old
            # prototype, as 3 labeled rows, anchors them over its class
            for label in old_labels:
                proto_rows += [(self.memory.label_to_index[label], self.label_to_id[label])] * 3
        n_rows = n_sel + len(proto_rows)
        n_cap = self.config.train_capacity(n_rows)
        slots = np.zeros((n_cap,), np.int64)
        poss = np.zeros((n_cap,), np.int64)
        lbls = np.zeros((n_cap,), np.int64)
        slots[:n_sel], poss[:n_sel], lbls[:n_sel] = sel_slots, sel_pos, sel_labels
        emb = st.emb[torch.from_numpy(slots).to(dev), torch.from_numpy(poss).to(dev)]
        if proto_rows:
            pslots = torch.tensor([s for s, _ in proto_rows], device=dev)
            emb[n_sel:n_rows] = st.proto[pslots]
            lbls[n_sel:n_rows] = [l for _, l in proto_rows]
        valid = torch.arange(n_cap, device=dev) < n_rows

        ewc_bundle = None
        distill_logits = None
        old_active = None
        if old_head is not None and not freeze_old:
            n_old = len(self.label_to_id) - len(new_classes)
            old_active = torch.arange(self._class_capacity, device=dev) < n_old
            old_padded = old_head
            if old_padded["out"]["w"].shape[1] < self._class_capacity:
                old_padded = head_lib.grow_capacity(old_padded, self._class_capacity,
                                                    self._generator(), n_old)
            if "skip" in self.head_params:
                old_padded = head_lib.ensure_skip(old_padded, self.embedding_dim)
            if self.config.incremental_distill_lambda > 0:
                with torch.no_grad():   # the old head's eval-mode logits
                    distill_logits = head_lib.head_forward(old_padded, emb)
            o_slots, o_pos = [], []
            for label in old_labels:
                slot = self.memory.label_to_index[label]
                for i in range(min(counts[label], 5)):
                    o_slots.append(slot)
                    o_pos.append(i)
            if o_slots:
                o_cap = self.config.train_capacity(len(o_slots))
                os_ = np.zeros((o_cap,), np.int64)
                op_ = np.zeros((o_cap,), np.int64)
                os_[:len(o_slots)] = o_slots
                op_[:len(o_pos)] = o_pos
                o_emb = st.emb[torch.from_numpy(os_).to(dev), torch.from_numpy(op_).to(dev)]
                ewc_bundle = ewc_lib.make_ewc_bundle(
                    old_padded, o_emb, torch.arange(o_cap, device=dev) < len(o_slots),
                    old_active, self._next_generator(),
                    ewc_lambda=self.config.incremental_ewc_lambda)

        grad_mask = None
        loss_type = "ce"
        labels_arr = torch.from_numpy(lbls).to(dev)
        if freeze_old:
            n_old = len(self.label_to_id) - len(new_classes)
            self._ensure_head_capacity()
            # the frozen trunk never saw the new class's input coordinates:
            # the new columns also get a linear probe on the raw embedding
            self.head_params = head_lib.ensure_skip(self.head_params, self.embedding_dim)
            cap = self.head_params["out"]["w"].shape[1]
            new_rows = (torch.arange(cap, device=dev) >= n_old).to(torch.float32)
            grad_mask = training.tree_map(torch.zeros_like, self.head_params)
            grad_mask["out"]["w"] = new_rows[None, :].expand_as(
                self.head_params["out"]["w"]).clone()
            grad_mask["out"]["b"] = new_rows
            grad_mask["skip"]["w"] = new_rows[None, :].expand_as(
                self.head_params["skip"]["w"]).clone()
            # one-vs-all sigmoid probes: BCE pushes a new logit negative on
            # every negative row, however confident the old logits are
            loss_type = "bce"
            labels_arr = torch.nn.functional.one_hot(labels_arr, cap).to(torch.float32)
            # zero the new columns' init, so what the probe holds is learned
            self.head_params = dict(self.head_params)
            self.head_params["out"] = {
                "w": self.head_params["out"]["w"] * (1.0 - new_rows[None, :]),
                "b": self.head_params["out"]["b"] * (1.0 - new_rows)}

        self.last_fit = training.fit_head(
            self.head_params, emb, labels_arr, valid, self._active_mask(),
            self._generator(7919 + self.train_steps),
            # the frozen probe is a linear one-vs-all fit from zero weights:
            # it needs a longer schedule, and cannot move the old columns
            lr=0.01 if freeze_old else 0.001, loss_type=loss_type,
            max_epochs=100 if freeze_old else 15, patience=10 if freeze_old else 3,
            use_scheduler=False,
            ewc_old=ewc_bundle.old_params if ewc_bundle else None,
            ewc_fisher=ewc_bundle.fisher if ewc_bundle else None,
            ewc_lambda=ewc_bundle.ewc_lambda if ewc_bundle else 0.0,
            distill_logits=distill_logits,
            distill_active=old_active if distill_logits is not None else None,
            distill_lambda=self.config.incremental_distill_lambda,
            distill_temperature=self.config.incremental_distill_temperature,
            grad_mask=grad_mask)
        self.head_params = self.last_fit.params
        self.train_steps += 1

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
        return self._predict_regular_batch([text], k)[0]

    def _predict_regular_batch(self, texts: List[str], k: int) -> Predictions:
        """``predict`` for many texts: the per-label-weight fusion over the
        full distribution, then its top-k."""
        if not self.label_to_id:
            return [[] for _ in texts]
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

        return self._predict_rows(texts, fuse, kk, k)

    def predict_batch(self, texts: List[str], k: int = 5,
                      batch_size: Optional[int] = None) -> Predictions:
        """Top-k labels per text: prototype top-k fused with the head's top-k
        at a fixed prototype share (the fitted one, else 0.7).

        ``batch_size`` caps the rows per device chunk (default
        ``config.embed_chunk_size``); it rides the call, so serving workers
        with their own sizes do not race."""
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
        """Shared predict pipeline.  Texts in the device cache are not
        embedded: their rows are gathered (the gathers queued first), the
        others are embedded in chunks and each chunk's rows stored in the
        ring.  Chunks of either kind are padded to the batch buckets {1, 8,
        64, chunk} so the device sees few shapes; each chunk's ``[pad,
        2·kk]`` block of scores and ids stays on the device until one copy
        to the host at the end, and no step in between waits for the
        device, so the host tokenizes chunk N+1 while the device runs N.
        The rows come back as misses then hits and are put back in request
        order.  A replaced ``_get_embeddings`` feeds its own rows and
        bypasses the device cache."""
        CH = self._chunk_size(chunk_override)
        cache = None if self._embeddings_overridden() else self._device_cache()
        if cache is not None:
            hits, miss_idx = cache.lookup(texts, self.config.max_length)
        else:
            hits, miss_idx = [], list(range(len(texts)))
        miss_texts = [texts[i] for i in miss_idx]
        packed, spans = [], []
        with torch.inference_mode():
            hit_chunks = []
            slots = [s for _, s in hits]
            for s0 in range(0, len(slots), CH):
                part = slots[s0:s0 + CH]
                n = len(part)
                hit_chunks.append((cache.gather(part + [0] * (self._pad_rows(n, CH) - n)), n))
            pos = 0
            chunks = (self._query_chunks(miss_texts, chunk_override) if miss_texts else ())
            for emb, n in chunks:
                with self._stage("knn_fusion"):
                    scores, idx = fuse(emb)
                packed.append(torch.cat([scores, idx.float()], dim=1))
                spans.append((n, scores.shape[0]))
                if cache is not None:
                    cache.store(miss_texts[pos:pos + n], self.config.max_length, emb)
                pos += n
            for emb, n in hit_chunks:
                with self._stage("knn_fusion"):
                    scores, idx = fuse(emb)
                packed.append(torch.cat([scores, idx.float()], dim=1))
                spans.append((n, scores.shape[0]))
            host = (torch.cat(packed, dim=0).cpu().numpy() if packed
                    else np.zeros((0, 2 * kk), np.float32))
        keep = np.zeros(host.shape[0], bool)
        off = 0
        for n, pad in spans:
            keep[off:off + n] = True
            off += pad
        host = host[keep]
        id2l = self.id_to_label
        results: Predictions = [[] for _ in texts]
        row_order = miss_idx + [i for i, _ in hits]
        for dest, srow, irow in zip(row_order, host[:, :kk].tolist(),
                                    host[:, kk:].astype(np.int64).tolist()):
            results[dest] = [(id2l[i], s) for s, i in zip(srow, irow)
                             if i >= 0 and i in id2l][:k]
        return results

    def _predict_from_embedding(self, embedding, k: int = 5, robust: bool = False,
                                strategic: bool = False) -> List[Tuple[str, float]]:
        """Top-k fusion of one embedding ``[D]`` at the config's
        ``prototype_weight`` / ``neural_weight``."""
        return self._predict_from_embeddings_batch(embedding, k, robust=robust,
                                                   strategic=strategic)[0]

    def _predict_from_embeddings_batch(self, embs, k: int = 5, robust: bool = False,
                                       strategic: bool = False) -> Predictions:
        """Top-k fusion of ``[B, D]`` embeddings (host arrays or tensors) at
        the config's ``prototype_weight`` / ``neural_weight`` (the robust
        and strategic weights apply in strategic mode only, which is not
        ported), with the recalibration bias."""
        pw, hw = self.config.prototype_weight, self.config.neural_weight
        if not isinstance(embs, torch.Tensor):
            embs = torch.tensor(np.asarray(embs, np.float32))
        emb = embs.to(self.device, torch.float32)
        emb = emb.reshape(-1, emb.shape[-1])
        kk = min(max(k, 1), self._class_capacity)
        with torch.inference_mode():
            sims = self.memory.sims_for(emb)
            logits = self._head_logits(emb)
            scores, ids = fusion.fuse_topk(
                sims, logits, self.memory.state.valid, self._active_mask(), pw, hw, kk,
                self.head_params is not None, proto_bias=self._proto_bias_arr())
            scores_np, ids_np = scores.cpu().numpy(), ids.cpu().numpy()
        id2l = self.id_to_label
        return [[(id2l[int(i)], float(s)) for s, i in zip(srow, irow)
                 if i >= 0 and int(i) in id2l][:k]
                for srow, irow in zip(scores_np, ids_np)]

    # the strategic entry points: strategic mode is not ported, and without
    # it the JAX package answers each of them as predict does
    def predict_robust(self, text: str, k: int = 5) -> List[Tuple[str, float]]:
        return self.predict_robust_batch([text], k)[0]

    def predict_strategic(self, text: str, k: int = 5) -> List[Tuple[str, float]]:
        return self.predict_strategic_batch([text], k)[0]

    def predict_robust_batch(self, texts: List[str], k: int = 5) -> Predictions:
        return self._predict_regular_batch(texts, k)

    def predict_strategic_batch(self, texts: List[str], k: int = 5) -> Predictions:
        return self._predict_regular_batch(texts, k)

    @staticmethod
    def _blend_dual(regular, strategic, rw: float, sw: float, k: int):
        blended: Dict[str, float] = {}
        for label, score in regular:
            blended[label] = score * rw
        for label, score in strategic:
            blended[label] = blended.get(label, 0.0) + score * sw
        preds = sorted(blended.items(), key=lambda x: x[1], reverse=True)
        total = sum(s for _, s in preds)
        if total > 0:
            preds = [(l, s / total) for l, s in preds]
        return preds[:k]

    def _predict_dual_batch(self, texts: List[str], k: int = 5) -> Predictions:
        """The regular and the strategic answers blended at the config's
        weights and renormalized over the top-k."""
        regular = self._predict_regular_batch(texts, k)
        strategic = self.predict_strategic_batch(texts, k)
        rw = self.config.strategic_blend_regular_weight
        sw = self.config.strategic_blend_strategic_weight
        return [self._blend_dual(r, s, rw, sw, k) for r, s in zip(regular, strategic)]

    def predict_proba(self, texts: Union[str, List[str]], calibrated: bool = False
                      ) -> Tuple[np.ndarray, List[str]]:
        """Full fused probability distribution per text → ``(probs
        [N, n_classes], labels)``: the per-label-weight fusion of
        ``predict``, returned whole; rows sum to 1.  ``calibrated=True``
        applies the temperature fitted by :meth:`calibrate`."""
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
            for emb, n in self._query_chunks(texts):
                parts.append(fusion.fuse_dist_from_emb(
                    emb, state.proto, state.valid, self.head_params, active,
                    pw, hw, self.head_params is not None,
                    pallas_min_classes=self.config.pallas_knn_min_classes,
                    proto_bias=proto_bias)[:n])
            probs = torch.cat(parts, dim=0).cpu().numpy()[:, :n_classes]
        if calibrated:
            if self._temperature_scaler is None:
                raise RuntimeError("predict_proba(calibrated=True) needs calibrate() first")
            probs = self._temperature_scaler.transform(probs)
        return probs, labels

    def calibrate(self, texts: List[str], labels: List[str]) -> Dict[str, Any]:
        """Fit a temperature on held-out labeled texts (calibration.py) →
        the report (T, NLL and ECE before and after); arms
        ``predict_proba(calibrated=True)``."""
        from .calibration import fit_classifier_temperature

        scaler, report = fit_classifier_temperature(self, texts, labels)
        self._temperature_scaler = scaler
        return report

    def predict_document(self, text: str, k: int = 5, chunk_tokens: Optional[int] = None,
                         overlap: float = 0.25, pool: str = "mean") -> List[Tuple[str, float]]:
        """Classify a text longer than the encoder window: overlapping token
        windows embedded in one device batch, pooled ``mean``, ``max`` or
        ``vote`` (document.py)."""
        from . import document

        return document.predict_document(self, text, k=k, chunk_tokens=chunk_tokens,
                                         overlap=overlap, pool=pool)

    # ------------------------------------------------------------------
    # statistics, representative examples, saving
    # ------------------------------------------------------------------
    def get_memory_stats(self) -> Dict[str, Any]:
        return self.memory.get_stats()

    def get_example_statistics(self) -> Dict[str, Any]:
        counts = {l: len(t) for l, t in self.memory.texts.items() if t}
        D = self.embedding_dim
        stats = {
            "total_examples": sum(counts.values()),
            "examples_per_class": counts,
            "num_classes": len(self.label_to_id),
            "train_steps": self.train_steps,
            "memory_usage": {"prototypes": len(counts) * D * 4,
                             "examples": sum(counts.values()) * D * 4},
        }
        if self.head_params is not None:
            stats["model_params"] = int(sum(p.numel() for p in
                                            training.tree_leaves(self.head_params)))
        return stats

    def clear_memory(self, labels: Optional[List[str]] = None):
        """Forget the stored examples of ``labels`` (all of them when None);
        the labels keep their ids.  The recalibration bias goes, as it was
        fitted on what the memory held."""
        self._proto_bias = None
        if labels is None:
            self.memory.clear()
            for idx in sorted(self.id_to_label):
                self.memory.register_label(self.id_to_label[idx])
        else:
            for label in labels:
                self.memory.remove_label(label)

    def merge_classifiers(self, other: "AdaptiveClassifier") -> "AdaptiveClassifier":
        """Take ``other``'s labels and stored examples, then refit the head.
        Rows are copied when both classifiers embed with the same model
        (across devices if need be); otherwise ``other``'s texts are
        embedded again with this classifier's encoder."""
        if self.embedding_dim != other.embedding_dim:
            raise ValueError("Classifiers have different embedding dimensions")
        same_space = self.model_name == other.model_name
        next_idx = max(self.id_to_label.keys()) + 1 if self.id_to_label else 0
        for label in other.label_to_id:
            if label not in self.label_to_id:
                self.label_to_id[label] = next_idx
                self.id_to_label[next_idx] = label
                self.memory.register_label(label)
                next_idx += 1
        for label, slot in other.memory.label_to_index.items():
            n = len(other.memory.texts.get(label, ()))
            if n == 0:
                continue
            texts = list(other.memory.texts[label])
            if same_space:
                embs = other.memory.state.emb[slot, :n].cpu().numpy()
            else:
                embs = self._get_embeddings(texts)
            self.memory.add_batch_host(texts, embs, [label] * n)
        self._proto_bias = None
        if self.head_params is not None:
            self._initialize_adaptive_head()
            self._ensure_head_capacity()
            self._train_adaptive_head()
        return self

    def select_representative_examples(self, examples: List[Example],
                                       k: int = 5) -> List[Example]:
        """The ``k`` examples nearest to the k-means centroids of their
        L2-normalized embeddings (a generator seeded 42, as the JAX package
        keys its k-means with ``PRNGKey(42)``); all of them when ``k`` or
        fewer."""
        if len(examples) <= k:
            return examples
        embs = np.stack([np.asarray(ex.embedding, np.float32) for ex in examples])
        embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        n = embs.shape[0]
        n_cap = self.config.train_capacity(n)
        x = torch.zeros((n_cap, embs.shape[1]), device=self.device)
        x[:n] = torch.from_numpy(embs).to(self.device)
        valid = torch.arange(n_cap, device=self.device) < n
        generator = torch.Generator(device=self.device).manual_seed(42)
        idx = kmeans.representative_indices(x, valid, generator, k)
        return [examples[int(i)] for i in idx.cpu().numpy()]

    def save(self, save_dir: Union[str, Path], include_onnx: bool = True,
             quantize_onnx: bool = True, include_quantized: Optional[bool] = None):
        """Write the checkpoint (``persistence.save_classifier``).
        ``include_onnx`` stands for the int8 encoder export ``quantized/``
        unless ``include_quantized`` is given; ``quantize_onnx`` is accepted
        for the JAX package's signature and ignored."""
        from . import persistence

        if include_quantized is None:
            include_quantized = include_onnx
        return persistence.save_classifier(self, Path(save_dir),
                                           include_quantized=include_quantized)
