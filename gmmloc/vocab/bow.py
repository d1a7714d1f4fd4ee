"""Binary bag-of-words vocabulary + keyframe database.

JAX replacement for the DBoW2 capability surface
(ref: /root/reference/orb_dbow2/: TemplatedVocabulary k-ary tree,
TF-IDF BowVector, FeatureVector node buckets, L1 scoring;
gmmloc/src/cv/orb_vocabulary.cpp wrapper). Differences by design:

  - the pretrained ORBvoc.bin asset is absent from the reference repo
    (.MISSING_LARGE_BLOBS) and our descriptors are not OpenCV-ORB
    bit-compatible anyway, so the vocabulary is TRAINED (hierarchical
    k-medians with majority-vote binary centers) on descriptors from the
    target domain; save/load uses a simple npz container.
  - tree descent runs as one vmapped device kernel over all features
    (L fixed steps of k-child Hamming argmin), not a pointer walk.
  - within-keyframe BoW-accelerated matching is unnecessary on the device (the
    full Hamming matrix is cheaper than bucketing — features/matching.py);
    the vocabulary exists for PLACE RECOGNITION: an inverted-index
    keyframe database with TF-IDF L1 scoring for relocalization — a
    capability extension the reference lacks (SURVEY.md §5.3).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _majority_center(descs: np.ndarray) -> np.ndarray:
    """Majority vote per bit (FORB::meanValue equivalent)."""
    bits = np.unpackbits(descs, axis=1)           # (n, 256)
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj)


def _hamming_np(a, b):
    return np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)


class Vocabulary:
    """k-ary tree of binary centers, depth L; leaves are words."""

    def __init__(self, children: np.ndarray, node_desc: np.ndarray,
                 word_id: np.ndarray, word_weight: np.ndarray,
                 k: int, depth: int):
        self.children = children        # (n_nodes, k) int32, -1 = none
        self.node_desc = node_desc      # (n_nodes, 32) uint8
        self.word_id = word_id          # (n_nodes,) int32, -1 for inner
        self.word_weight = word_weight  # (n_words,) float32 idf
        self.k = k
        self.depth = depth
        self.n_words = len(word_weight)
        self._desc_fn = self._build_descend()

    # -------------------------------------------------------------- train

    @classmethod
    def train(cls, descs: np.ndarray, k: int = 10, depth: int = 4,
              seed: int = 0, kmeans_iters: int = 8) -> "Vocabulary":
        """Hierarchical binary k-medians (TemplatedVocabulary::create)."""
        rng = np.random.default_rng(seed)
        children_l: List[List[int]] = [[-1] * k]  # root = node 0
        desc_l: List[np.ndarray] = [np.zeros(32, np.uint8)]
        word_rows: List[int] = []

        def cluster(node: int, subset: np.ndarray, level: int):
            if level == depth or len(subset) <= k:
                # leaf: this node is a word
                word_rows.append(node)
                return
            # k-medians with majority-vote centers
            uniq = np.unique(subset, axis=0)
            kk = min(k, len(uniq))
            centers = uniq[rng.choice(len(uniq), kk, replace=False)]
            for _ in range(kmeans_iters):
                d = _hamming_np(subset, centers)
                assign = d.argmin(1)
                new_centers = []
                for c in range(kk):
                    sel = subset[assign == c]
                    new_centers.append(
                        _majority_center(sel) if len(sel) else centers[c]
                    )
                centers = np.stack(new_centers)
            d = _hamming_np(subset, centers)
            assign = d.argmin(1)
            for c in range(kk):
                child = len(desc_l)
                children_l.append([-1] * k)
                desc_l.append(centers[c])
                children_l[node][c] = child
                sel = subset[assign == c]
                if len(sel):
                    cluster(child, sel, level + 1)
                else:
                    word_rows.append(child)

        cluster(0, np.asarray(descs, np.uint8), 0)

        n_nodes = len(desc_l)
        children = np.full((n_nodes, k), -1, np.int32)
        for i, ch in enumerate(children_l):
            children[i] = ch
        node_desc = np.stack(desc_l)
        word_id = np.full(n_nodes, -1, np.int32)
        for w, node in enumerate(word_rows):
            word_id[node] = w
        # idf weights from the training corpus (uniform doc assumption)
        weight = np.ones(len(word_rows), np.float32)
        voc = cls(children, node_desc, word_id, weight, k, depth)
        # set idf from training descriptor distribution
        words = voc.transform_words(descs)
        counts = np.bincount(words[words >= 0], minlength=voc.n_words) + 1
        voc.word_weight = np.log(len(descs) / counts).astype(np.float32)
        return voc

    # ---------------------------------------------------------- transform

    def _build_descend(self):
        children = jnp.asarray(self.children)
        node_desc = jnp.asarray(self.node_desc)
        word_id = jnp.asarray(self.word_id)
        depth = self.depth
        k = self.k

        @jax.jit
        def descend(desc):
            """(N,32) uint8 -> (N,) word ids (-1 if lost)."""

            def step(node, _):
                ch = children[node]                        # (N, k)
                cd = node_desc[jnp.clip(ch, 0)]            # (N, k, 32)
                x = jax.lax.bitwise_xor(cd, desc[:, None, :])
                dist = jnp.sum(
                    jax.lax.population_count(x).astype(jnp.int32), axis=-1
                )
                dist = jnp.where(ch >= 0, dist, 1 << 20)
                nxt = jnp.take_along_axis(
                    ch, jnp.argmin(dist, axis=1)[:, None], axis=1
                )[:, 0]
                # stop at leaves (no children)
                has_child = jnp.any(children[node] >= 0, axis=1)
                return jnp.where(has_child, nxt, node), None

            node0 = jnp.zeros(desc.shape[0], jnp.int32)
            node, _ = jax.lax.scan(step, node0, None, length=depth)
            return word_id[node]

        return descend

    def transform_words(self, descs) -> np.ndarray:
        return np.asarray(self._desc_fn(jnp.asarray(descs, jnp.uint8)))

    def bow_vector(self, descs, valid=None) -> np.ndarray:
        """TF-IDF L1-normalized word histogram (n_words,)."""
        words = self.transform_words(descs)
        if valid is not None:
            words = words[np.asarray(valid)]
        words = words[words >= 0]
        v = np.zeros(self.n_words, np.float32)
        np.add.at(v, words, 1.0)
        v *= self.word_weight
        s = v.sum()
        return v / s if s > 0 else v

    @staticmethod
    def score_l1(a: np.ndarray, b: np.ndarray) -> float:
        """DBoW2 L1 score in [0,1] (ScoringObject.cpp L1Scoring)."""
        return float(1.0 - 0.5 * np.abs(a - b).sum())

    # ------------------------------------------------------------ save/load

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, children=self.children, node_desc=self.node_desc,
            word_id=self.word_id, word_weight=self.word_weight,
            k=self.k, depth=self.depth,
        )

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        z = np.load(path)
        return cls(
            z["children"], z["node_desc"], z["word_id"], z["word_weight"],
            int(z["k"]), int(z["depth"]),
        )

    # ------------------------------------------------- DBoW2 binary format

    @classmethod
    def load_dbow2(cls, path: str, desc_len: int = 32) -> "Vocabulary":
        """Parse a DBoW2 packed binary vocabulary (ORBvoc.bin).

        Wire format (ref: orb_dbow2 TemplatedVocabulary.h
        loadFromBinaryFile/saveToBinaryFile): 24-byte header of six
        4-byte little-endian ints (nb_nodes, size_node, k, L, scoring,
        weighting), then one record per non-root node in node-id order:
        int32 parent, desc_len descriptor bytes, float32 weight, one
        is_leaf byte (size_node = desc_len + 9). Children order is the
        file order of their records (the reference's push_back); leaf
        word ids are assigned in node-id order."""
        raw = open(path, "rb").read()
        hdr = np.frombuffer(raw[:24], "<u4")
        nb_nodes, size_node, k, L = int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3])
        if size_node != desc_len + 9:
            raise ValueError(
                f"size_node {size_node} != desc_len+9 ({desc_len + 9})"
            )
        body = raw[24:]
        n_rec = len(body) // size_node
        # the reference writes nodes 1..nb_nodes-1 and reads until EOF
        n_rec = min(n_rec, max(nb_nodes - 1, 0))
        rec = np.frombuffer(
            body[: n_rec * size_node], np.uint8
        ).reshape(n_rec, size_node)
        parent = rec[:, :4].copy().view("<i4")[:, 0]
        desc = rec[:, 4 : 4 + desc_len]
        weight = rec[:, 4 + desc_len : 8 + desc_len].copy().view("<f4")[:, 0]
        is_leaf = rec[:, 8 + desc_len] != 0

        n_nodes = n_rec + 1
        children = np.full((n_nodes, k), -1, np.int32)
        n_child = np.zeros(n_nodes, np.int32)
        node_desc = np.zeros((n_nodes, desc_len), np.uint8)
        node_desc[1:] = desc
        word_id = np.full(n_nodes, -1, np.int32)
        w = 0
        for i in range(n_rec):
            nid = i + 1
            p = int(parent[i])
            children[p, n_child[p]] = nid
            n_child[p] += 1
            if is_leaf[i]:
                word_id[nid] = w
                w += 1
        word_weight = weight[is_leaf].astype(np.float32)
        return cls(children, node_desc, word_id, word_weight, k, L)

    def save_dbow2(self, path: str) -> None:
        """Write the DBoW2 packed binary format (round-trip counterpart
        of load_dbow2; same record layout as saveToBinaryFile)."""
        n_nodes = len(self.node_desc)
        desc_len = self.node_desc.shape[1]
        # reconstruct per-node parent pointers from the children table
        parent = np.zeros(n_nodes, np.int32)
        for p in range(n_nodes):
            for c in self.children[p]:
                if c >= 0:
                    parent[c] = p
        with open(path, "wb") as f:
            f.write(
                np.array(
                    [n_nodes, desc_len + 9, self.k, self.depth, 0, 0], "<u4"
                ).tobytes()
            )
            for nid in range(1, n_nodes):
                f.write(np.int32(parent[nid]).tobytes())
                f.write(self.node_desc[nid].tobytes())
                wgt = (
                    self.word_weight[self.word_id[nid]]
                    if self.word_id[nid] >= 0
                    else 0.0
                )
                f.write(np.float32(wgt).tobytes())
                f.write(bytes([1 if self.word_id[nid] >= 0 else 0]))


class KeyFrameDatabase:
    """Inverted-index place-recognition database (relocalization).

    Capability extension: the reference has no relocalization — a failed
    track simply ends the run (gmmloc.cpp:157-159, SURVEY.md §5.3).
    """

    def __init__(self, voc: Vocabulary):
        self.voc = voc
        # inverted file: word -> {kf: tf-idf value}. BoW vectors are
        # L1-normalized and sparse (<= n_features nonzero words), so a
        # query touches only its own words' posting lists — sub-linear in
        # the number of stored keyframes (DBoW2 TemplatedDatabase::query
        # inverted-file semantics, TemplatedDatabase.h).
        self.inv: List[dict] = [{} for _ in range(voc.n_words)]
        self.bow: dict = {}  # kf -> (word_ids int32, values float32)

    def add(self, kf: int, descs, valid=None) -> None:
        v = self.voc.bow_vector(descs, valid)
        words = np.where(v > 0)[0].astype(np.int32)
        vals = v[words]
        self.bow[kf] = (words, vals)
        for w, x in zip(words, vals):
            self.inv[w][kf] = float(x)

    def remove(self, kf: int) -> None:
        ent = self.bow.pop(kf, None)
        if ent is None:
            return
        for w in ent[0]:
            self.inv[w].pop(kf, None)

    def query(self, descs, valid=None, top: int = 5) -> List[Tuple[int, float]]:
        """Candidate KFs by shared words via the inverted file, scored
        TF-IDF L1 (DBoW2 ScoringObject.cpp L1Scoring).

        With a,b L1-normalized:  |a-b|_1 = 2 + sum_shared(|a_w-b_w| -
        a_w - b_w), so  score = 1 - 0.5|a-b|_1 = -0.5*sum_shared(...)
        — computable from the shared words alone. Cost is
        O(sum_{query words} |posting list|), not O(n_kf * n_words).
        Exactly equal to the dense formula (tests/test_vocab.py).
        No share-count prefilter (ORB-SLAM2's 0.8*max cut degenerates
        when the vocabulary is small relative to the per-frame feature
        count); every KF sharing >=1 word is scored."""
        if not self.bow:
            return []
        v = self.voc.bow_vector(descs, valid)
        acc: dict = {}
        for w in np.where(v > 0)[0]:
            a_w = float(v[w])
            for kf, b_w in self.inv[w].items():
                acc[kf] = acc.get(kf, 0.0) + abs(a_w - b_w) - a_w - b_w
        if not acc:
            return []
        kfs = np.fromiter(acc.keys(), np.int64, len(acc))
        scores = -0.5 * np.fromiter(acc.values(), np.float64, len(acc))
        order = np.argsort(-scores)[:top]
        return [(int(kfs[i]), float(scores[i])) for i in order if scores[i] > 0.0]
