"""ArtiBoostLoader: the online exploration-and-synthesis orchestrator
(counterpart of ``artiboost_tpu/artiboost/loader.py``; reference
``anakin/artiboost/artiboost_loader.py``).

Ported: construction (including the md5-keyed blacklist cache),
``prepare`` (weighted triplet draw + chunked pose sweep), the mixed
real/synth train iteration (``__iter__`` and ``iter_parts``, with the
epoch's real and synth permutations), ``prepare_val`` / ``iter_val``
(the uniform sweep without replacement, rendered batch by batch),
``should_val``, ``step_eval`` / ``sample_reweight`` (mining),
``synth_shutdown`` and the checkpoint state.

Under a process group (``parallel/mesh.py``, the JAX loader's mesh
branches) the loader keeps JAX's roundings (``round_len_train``,
``sweep_chunk``, ``val_count``, ``mixed_counts``), every rank makes every
draw of the global batch from the same seeded generator, and each rank
computes only its own rows: its share of each pose-sweep chunk (the pose
cache then all-gathered, loader.py:139-150), of each synth render
(:192-200) and of each real half, whose host half every rank builds whole
so that the dataset's draws stay in plan order (``put_global``).

Randomness comes from a ``DrawSource``: the default draws from one
``torch.Generator``; a test can hand in one that replays recorded draws."""
from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from artiboost_torch.artiboost.ccv import (
    CCVSpace,
    build_blacklist_map,
    init_ccv_space,
    sample_triplets_draws,
    triplets_from_flat,
)
from artiboost_torch.artiboost.grasp_library import get_grasp_library
from artiboost_torch.artiboost.mining import UPDATE_METHODS
from artiboost_torch.artiboost.object_library import get_object_library
from artiboost_torch.artiboost.pose_generator import GeneratedPoses, PoseGenerator, cat_poses
from artiboost_torch.artiboost.refiner import build_refiner
from artiboost_torch.artiboost.renderer import default_render_assets
from artiboost_torch.artiboost.scrambler import Scrambler
from artiboost_torch.artiboost.synth_batch import SynthBatch, SynthConfig
from artiboost_torch.artiboost.view_engine import ViewEngineConfig, persp_rotmat_centers
from artiboost_torch.mano.model import ManoModel, get_mano_model
from artiboost_torch.metrics.val_metric import ValMetricAR2, ValMetricMean3DEPE2
from artiboost_torch.parallel import mesh
from artiboost_torch.utils import profiling
from artiboost_torch.utils.batching import union_concat
from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.utils.prefetch import IN_PLACE


def round_len_train(n: int, n_ranks: int) -> int:
    """CONFIG_LEN_TRAIN rounded up to tile the ranks (loader.py:214-216)."""
    return -(-n // n_ranks) * n_ranks if n_ranks > 1 else n


def sweep_chunk(n: int, opg_batch_size: int, n_ranks: int) -> int:
    """The pose sweep's chunk for n triplets, rounded up to tile the ranks
    (loader.py:256-260)."""
    chunk = min(opg_batch_size, n)
    return max(-(-chunk // n_ranks) * n_ranks, n_ranks) if n_ranks > 1 else chunk


def val_count(config_len_val: int, n_valid: int, batch_size: int, n_ranks: int) -> int:
    """The val sweep's triplet count: VAL_LEN within the non-blacklisted
    triplets, whole batches when there is one, then rounded down to tile
    the ranks (loader.py:311-319)."""
    n = max(min(config_len_val, n_valid), 1)
    if n >= batch_size:
        n = (n // batch_size) * batch_size
    return max((n // n_ranks) * n_ranks, n_ranks) if n_ranks > 1 else n


def mixed_counts(batch_size: int, real_len: int, synth_len: int, n_ranks: int) -> Tuple[int, int]:
    """(real, synth) samples per batch in proportion to the epoch's real
    length and CONFIG_LEN_TRAIN; across ranks the synth count rounds to the
    nearest multiple of the world, keeping one a rank and a real slice
    (loader.py:365-381)."""
    if real_len + synth_len == 0:
        return 0, 0
    n_synth = batch_size if real_len == 0 else int(
        round(batch_size * synth_len / (real_len + synth_len)))
    if real_len and n_synth and n_ranks > 1:
        n_synth = max(int(round(n_synth / n_ranks)) * n_ranks, n_ranks)
        n_synth = min(n_synth, max(batch_size - n_ranks, n_ranks))
    return batch_size - n_synth, n_synth


def cached_blacklist(cache_path: str, build: Callable[[], torch.Tensor], device
                     ) -> torch.Tensor:
    """The CCV blacklist from its disk cache, else ``build()``, cached. Ranks
    that start together share the cache: it is written to a file of the
    writer's own and renamed into place, so a reader finds no cache or all
    of it (``np.load`` of a half-written file raises, it does not return
    another map)."""
    if os.path.isfile(cache_path):
        return torch.from_numpy(np.load(cache_path)).to(device)
    blacklist = build()
    write_npy(cache_path, blacklist.cpu().numpy())
    return blacklist


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (read to the host)."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def write_npy(path: str, array: np.ndarray) -> None:
    """``np.save`` to a file of this writer's own in ``path``'s directory,
    renamed onto ``path`` once whole."""
    cache_dir = os.path.dirname(path) or "."
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.save(f, array)
    os.replace(tmp, path)


class DrawSource:
    """Every random draw of the loader, from one generator."""

    def __init__(self, generator: torch.Generator, device):
        self.generator, self.device = generator, device
        self.own_digests: List[str] = []

    def triplets(self, space: CCVSpace, n: int, replace: bool) -> torch.Tensor:
        """The CCV draw. From equal weights and generator states it is the
        same bits in every process (``sample_triplets_draws``). Under a
        process group every rank still takes rank 0's ids, as JAX's one SPMD
        program makes one draw (each rank draws, so the generators stay
        equal), and ``own_digests`` keeps the digest of this rank's own ids
        from before the broadcast, so a check can hold every rank's own draw
        to rank 0's."""
        flat = sample_triplets_draws(space, self.generator, n, replace=replace)
        if mesh.world() == 1:
            return flat
        self.own_digests.append(digest(flat))
        return mesh.broadcast_(flat)

    def poses(self, pose_generator, B: int) -> Dict:
        return pose_generator.draws(self.generator, B, self.device)

    def synth(self, synth_fn: SynthBatch, B: int) -> Dict:
        return synth_fn.draws(self.generator, B)

    def perm_seed(self) -> int:
        """Seed of one epoch permutation (numpy RandomState, as the JAX
        package seeds it from ``jax.random.randint``)."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                                 device=self.device))

    def loss(self, criterion) -> List[Dict]:
        """The criterion's draws for one step."""
        with profiling.trace("model/loss_draws"):
            return criterion.draws(self.generator, self.device)


class ArtiBoostLoader:
    def __init__(self, real_dataset=None, cfg: Optional[Dict] = None, batch_size: int = 128,
                 n_epochs: int = 100, mano_model: Optional[ManoModel] = None,
                 seed: int = 0, device=None, draws: Optional[DrawSource] = None):
        """``real_dataset`` has ``sample_batch(idx) -> dict`` and a length
        (an ``HODataset``), or is None for synth-only training."""
        cfg = cfg or {}
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.n_ranks = mesh.world()
        if batch_size % self.n_ranks:
            raise ValueError(f"batch size {batch_size} does not tile {self.n_ranks} ranks")
        self.n_epochs = n_epochs
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.draws = draws if draws is not None else DrawSource(self.generator, self.device)
        self.use_synth = True
        self.epoch_idx = 0

        obj_cfg = cfg.get("OBJ_ENGINE", {})
        obj_names = list(obj_cfg.get("OBJ", ["obj_a", "obj_b", "obj_c", "obj_d"]))
        dataset_type = obj_cfg.get("OBJ_ORIGIN_DATASET", "HO3D")
        n_grasp = int(cfg.get("GRASP_ENGINE", {}).get("GRASP_NUM", 50))
        view_node = cfg.get("VIEW_ENGINE", {})
        z_range = view_node.get("CAMERA_Z_RANGE", [0.45, 0.55])
        self.view_cfg = ViewEngineConfig(
            persp_u_bins=int(view_node.get("PERSP_U_BINS", 12)),
            persp_theta_bins=int(view_node.get("PERSP_THETA_BINS", 24)),
            camera_z_min=float(z_range[0]), camera_z_max=float(z_range[1]))

        self.mano_model = (mano_model if mano_model is not None
                           else get_mano_model(device=self.device)).to(self.device)
        self.obj_lib = get_object_library(obj_names, dataset_type, device=self.device)
        self.grasp_lib = get_grasp_library(obj_names, n_grasp, device=self.device)

        n_obj, n_persp = len(obj_names), self.view_cfg.n_persp
        blacklist = None
        if cfg.get("FILTER", {}).get("BACK", True):
            # disk cache keyed by engine identity (reference
            # artiboost_loader.py:428-449)
            ident = hashlib.md5(repr((
                sorted(obj_names), dataset_type, n_grasp, self.view_cfg.persp_u_bins,
                self.view_cfg.persp_theta_bins,
                self.grasp_lib.hand_pose[..., :3].cpu().numpy().tobytes(),
            )).encode()).hexdigest()
            cache_dir = cfg.get("CACHE_DIR", "common/cache/CCV_blacklist_torch")
            blacklist = cached_blacklist(
                os.path.join(cache_dir, f"{ident}.npy"), lambda: build_blacklist_map(
                    self.grasp_lib.hand_pose, persp_rotmat_centers(self.view_cfg, self.device)),
                self.device)
            logger.info(f"blacklist: {float(blacklist.mean()) * 100:.1f}% of "
                        f"{n_obj * n_persp * n_grasp} CCV triplets filtered")
        self.ccv = init_ccv_space(n_obj, n_persp, n_grasp, blacklist, device=self.device)

        self.update_method_key = cfg.get("UPDATE_METHOD", "method_1")
        wu = cfg.get("WEIGHT_UPDATE", {})
        self.weight_lower = float(wu.get("LOWER", 0.1))
        self.weight_upper = float(wu.get("UPPER", 10.0))
        dt = cfg.get("DIST_THRESHOLD", {})
        self.dist_lower = float(dt.get("LOWER", 8.0))
        self.dist_upper = float(dt.get("UPPER", 16.0))
        self.synth_shutdown_ratio = float(cfg.get("SYNTH_SHUTDOWN_RATIO", 0.0))
        self.last_dist_lower_ratio = -1.0

        scrambler = Scrambler(cfg.get("SCRAMBLER", {"TYPE": "random",
                                                    "HAND_TSL_SIGMA": 0.01,
                                                    "HAND_POSE_SIGMA": 0.1}))
        refiner = build_refiner(cfg.get("REFINER", {"TYPE": "null"}), self.mano_model,
                                device=self.device)
        self.pose_generator = PoseGenerator(self.mano_model, self.obj_lib, self.grasp_lib,
                                            self.view_cfg, scrambler, refiner)

        rend = cfg.get("RENDERER", {})
        cam = rend.get("CAM_PARAM", {})
        preset = cfg.get("DATA_PRESET", {})
        self.synth_cfg = SynthConfig(
            image_size=int(preset.get("IMAGE_SIZE", [224, 224])[0]),
            raw_size=int(rend.get("RENDER_SIZE", [512, 512])[0]),
            fx=float(cam.get("FX", 435.0)), fy=float(cam.get("FY", 435.0)),
            cx=float(cam.get("CX", 256.0)), cy=float(cam.get("CY", 256.0)),
            crop_model=preset.get("CROP_MODEL", "root_obj"),
            center_idx=int(preset.get("CENTER_IDX", 0)),
            bbox_expand_ratio=float(preset.get("BBOX_EXPAND_RATIO", 1.2)),
            cull_backfaces=bool(rend.get("CULL_BACKFACES", True)),
            lod_faces=int(rend.get("LOD_FACES", -1)),
            textured=bool(rend.get("TEXTURED", True)),
            bilinear=bool(rend.get("BILINEAR", False)),
            tex_subsample=int(rend.get("TEX_SUBSAMPLE", 2)),
            image_bf16=bool(rend.get("IMAGE_BF16", True)),
            render_scale=rend.get("RENDER_SCALE"),
            motion_blur=int(rend.get("MOTION_BLUR", 0)),
            motion_blur_prob=float(rend.get("MOTION_BLUR_PROB", 1.0)))
        self.assets = default_render_assets(self.mano_model, bgs_path=rend.get("BGS_PATH"),
                                            html_path=rend.get("HTML_PATH", "data/HTML_supp"),
                                            device=self.device)
        self.synth_batch_fn = SynthBatch(self.mano_model, self.obj_lib, self.assets,
                                         self.synth_cfg, device=self.device)

        self.opg_batch_size = int(cfg.get("OPG_BATCH_SIZE", 1024))
        # epoch sizing (reference: synth_len = synth_factor * len(real))
        self.real_dataset = real_dataset
        self.synth_factor = float(cfg.get("SYNTH_FACTOR", 0.6))
        self.config_len_train = round_len_train(int(cfg.get(
            "CONFIG_LEN_TRAIN", max(int(self.synth_factor * self._real_len()), batch_size))),
            self.n_ranks)
        self.generated: Optional[GeneratedPoses] = None
        self.has_val_sweep = "VAL_LEN" in cfg
        self.config_len_val = int(cfg.get("VAL_LEN", self.config_len_train))
        self.val_start_epoch = int(cfg.get("VAL_START_EPOCH", 0))
        self.val_freq = int(cfg.get("VAL_FREQ", 1))
        self.generated_val: Optional[GeneratedPoses] = None

    # ---- epoch lifecycle ----
    def prepare(self):
        """Weighted triplet draw (with replacement) + the epoch's pose cache."""
        if not self.use_synth:
            return
        flat = self.draws.triplets(self.ccv, self.config_len_train, replace=True)
        oid, vid, gid, occ = triplets_from_flat(self.ccv, flat)
        self.ccv = self.ccv._replace(occurrence_map=occ)
        self.generated = self._generate_poses(oid, vid, gid)

    def _generate_poses(self, oid, vid, gid) -> GeneratedPoses:
        """Pose sweep in fixed-size chunks (OPG_BATCH_SIZE), the tail
        repeat-padded to a full chunk and trimmed after. Across ranks each
        computes its rows of every chunk and the chunk is all-gathered."""
        n = int(oid.shape[0])
        chunk = sweep_chunk(n, self.opg_batch_size, self.n_ranks)
        n_pad = -(-n // chunk) * chunk
        if n_pad != n:
            pad = n_pad - n
            oid, vid, gid = (torch.cat([x, x[:pad]]) for x in (oid, vid, gid))
        lo, hi = mesh.rows(chunk)
        pieces = []
        with profiling.trace("engine/sweep", triplets=n):
            for s in range(0, n_pad, chunk):
                with profiling.trace("engine/chunk"):
                    draws = mesh.shard_rows(self.draws.poses(self.pose_generator, chunk), chunk)
                    piece = self.pose_generator(oid[s + lo:s + hi], vid[s + lo:s + hi],
                                                gid[s + lo:s + hi], draws)
                    if self.n_ranks > 1:
                        piece = GeneratedPoses(*(mesh.all_gather_rows(x) for x in piece))
                pieces.append(piece)
            return cat_poses(pieces, n)

    def prepare_val(self):
        """Val sweep (reference ovg_set.py:104-132): uniform weights masked
        by the blacklist, drawn WITHOUT replacement, VAL_LEN long (rounded
        down to whole batches)."""
        if not self.use_synth:
            return
        O, V, G = self.ccv.shape
        n_valid = O * V * G - int(self.ccv.blacklist_map.sum())
        n = val_count(self.config_len_val, n_valid, self.batch_size, self.n_ranks)
        uniform = self.ccv._replace(sample_weight_map=torch.ones_like(self.ccv.sample_weight_map))
        flat = self.draws.triplets(uniform, n, replace=False)
        oid, vid, gid, occ = triplets_from_flat(self.ccv, flat)
        self.ccv = self.ccv._replace(occurrence_map=occ)
        self.generated_val = self._generate_poses(oid, vid, gid)
        logger.info(f"val sweep: {n} triplets drawn w/o replacement "
                    f"({n_valid} non-blacklisted of {O * V * G})")

    def should_val(self, epoch_idx: int) -> bool:
        return (self.use_synth and self.has_val_sweep
                and epoch_idx + 1 >= self.val_start_epoch
                and epoch_idx % self.val_freq == self.val_freq - 1)

    def len_val(self) -> int:
        """The val sweep's batch count (JAX ``loader.py:336-339``)."""
        if self.generated_val is None:
            return 0
        return max(int(self.generated_val.obj_id.shape[0]) // self.batch_size, 1)

    def iter_val(self) -> Iterator[Dict]:
        """Pure-synth val batches in draw order (each triplet once); across
        ranks this rank's rows of each."""
        if self.generated_val is None:
            raise RuntimeError("prepare_val() must run before iter_val()")
        n = int(self.generated_val.obj_id.shape[0])
        bs = min(self.batch_size, n)
        lo, hi = mesh.rows(bs)
        for s in range(0, n - bs + 1, bs):
            idx = torch.arange(s + lo, s + hi, device=self.device)
            with profiling.trace("synth/draws"):
                draws = mesh.shard_rows(self.draws.synth(self.synth_batch_fn, bs), bs)
            yield self.synth_batch_fn(self.generated_val, idx, draws)

    # ---- the train epoch: mixed real/synth batches ----
    def _real_len(self) -> int:
        return len(self.real_dataset) if self.real_dataset is not None else 0

    def _mixed_counts(self) -> Tuple[int, int]:
        """(real, synth) samples per global batch (``mixed_counts``)."""
        return mixed_counts(self.batch_size, self._real_len(),
                            self.config_len_train if self.use_synth else 0, self.n_ranks)

    def _synth_epoch_perm(self, seed: int) -> np.ndarray:
        """Fresh permutation of the pose cache: every synth sample is
        visited once per epoch (slices wrap when the epoch needs more)."""
        return np.random.RandomState(seed).permutation(self.generated.obj_id.shape[0])

    def __len__(self) -> int:
        synth_len = self.config_len_train if self.use_synth else 0
        return max((self._real_len() + synth_len) // self.batch_size, 1)

    def iter_plan(self) -> Iterator[Tuple[Optional[List[int]], Optional[np.ndarray]]]:
        """(real sample indices or None, synth pose indices or None) per
        step, host values only, so a producer thread can walk the plan. Both
        epoch permutations are drawn when the iterator is made."""
        n_real, n_synth = self._mixed_counts()
        real_len = self._real_len()
        real_perm = np.random.RandomState(self.draws.perm_seed()).permutation(max(real_len, 1))
        use_synth = bool(n_synth) and self.generated is not None
        synth_perm = self._synth_epoch_perm(self.draws.perm_seed()) if use_synth else None
        n_batches = len(self)

        def plan():
            real_ptr = 0
            for b in range(n_batches):
                real_idx = None
                if n_real and self.real_dataset is not None:
                    real_idx = [int(real_perm[(real_ptr + i) % real_len]) for i in range(n_real)]
                    real_ptr += n_real
                synth_idx = None
                if use_synth:
                    start = b * n_synth
                    synth_idx = synth_perm[np.arange(start, start + n_synth) % len(synth_perm)]
                yield real_idx, synth_idx

        return plan()

    def synth_indices(self, synth_idx: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """A plan's synth pose indices on the device (all of the global
        batch's: ``synth_part`` renders this rank's rows)."""
        if synth_idx is None:
            return None
        with profiling.trace("synth/indices"):
            host = torch.as_tensor(synth_idx, dtype=torch.int64)
            if self.device.type != "cuda":
                return host
            # from pinned memory without waiting: a pageable copy synchronizes
            return host.pin_memory().to(self.device, non_blocking=True)

    def real_part(self, host_batch) -> Dict:
        """The device half of a plan's real batch: this rank's rows of the
        host half every rank built."""
        rows = mesh.rows(len(host_batch.sample_idx)) if self.n_ranks > 1 else None
        return self.real_dataset.device_half(host_batch, rows=rows)

    def iter_parts(self) -> Iterator[Tuple[Optional[Dict], Optional[torch.Tensor]]]:
        """(real batch or None, synth pose indices or None) per step, on the
        calling thread (the host halves of ``iter_plan`` through
        ``HostPipeline.host_halves``, in place, then their device halves);
        the synth half is rendered by the caller (``synth_part``), as the
        JAX package's pipelined step does (loader.py:434-469).
        ``train.train_epoch`` walks the same plan with the real halves
        prefetched."""
        halves = IN_PLACE.host_halves(self.real_dataset, self.iter_plan(), self._mixed_counts()[0])
        return ((None if hb is None else self.real_part(hb), self.synth_indices(s))
                for hb, s in halves)

    def synth_part(self, sidx: torch.Tensor) -> Dict:
        """Render the synth half of a train batch from the epoch's poses:
        the draws of all ``sidx``, this rank's rows rendered."""
        n = int(sidx.shape[0])
        with profiling.trace("synth/draws"):
            draws = mesh.shard_rows(self.draws.synth(self.synth_batch_fn, n), n)
        lo, hi = mesh.rows(n)
        return self.synth_batch_fn(self.generated, sidx[lo:hi], draws)

    def __iter__(self) -> Iterator[Dict]:
        """Mixed batches over the key union (``utils.batching.union_concat``:
        a key one half lacks is filled and masked under KEY_VALID)."""
        for real, sidx in self.iter_parts():
            parts = [p for p in (real, None if sidx is None else self.synth_part(sidx)) if p]
            if not parts:
                raise RuntimeError("ArtiBoostLoader has neither real nor synth data")
            yield union_concat(parts)

    # ---- mining ----
    def step_eval(self, epoch_idx: int, evaluator) -> None:
        """Average the per-triplet maps of the evaluator's ValMetrics (the
        EPE's and the MSSD's), AND their seen masks, and reweight
        (``artiboost_tpu/artiboost/loader.py:473-489``)."""
        self.epoch_idx = epoch_idx
        if not self.use_synth:
            return
        with profiling.trace("mining/step_eval"):
            maps = [m.get_averaged_maps() for m in evaluator.metrics_list
                    if isinstance(m, (ValMetricMean3DEPE2, ValMetricAR2))]
            if not maps:
                logger.warning("no ValMetric found; skipping ArtiBoost reweight")
                return
            avg = sum(m[0] for m in maps) / len(maps)
            seen = maps[0][1]
            for m in maps[1:]:
                seen = seen & m[1]
            self.sample_reweight(avg, seen, epoch_idx)
        logger.info(f"ArtiBoost finished mining after epoch {epoch_idx}")

    def sample_reweight(self, val_map, seen, epoch_idx: int):
        update = UPDATE_METHODS[self.update_method_key](
            self.ccv.sample_weight_map, val_map, seen, self.weight_lower, self.weight_upper,
            dist_lower_threshold=self.dist_lower, dist_upper_threshold=self.dist_upper,
            epoch_idx=epoch_idx, n_epochs=self.n_epochs)
        self.ccv = self.ccv._replace(sample_weight_map=update["sample_weight_map"])
        if "dist_lower_ratio" in update:
            ratio = float(update["dist_lower_ratio"])
            self.last_dist_lower_ratio = ratio
            if ratio >= 0 and 0 < self.synth_shutdown_ratio <= ratio:
                if self.real_dataset is None:
                    logger.warning(f"dist_lower_ratio {ratio:.2%} >= SYNTH_SHUTDOWN_RATIO "
                                   f"{self.synth_shutdown_ratio:.2%} but there is no real "
                                   "dataset to continue on; keeping synthesis alive")
                else:
                    logger.warning(f"dist_lower_ratio {ratio:.2%} >= SYNTH_SHUTDOWN_RATIO "
                                   f"{self.synth_shutdown_ratio:.2%}: early synth shutdown; "
                                   "training continues real-only")
                    self.synth_shutdown()

    def synth_shutdown(self):
        self.use_synth = False
        self.generated = None
        self.generated_val = None
        logger.warning("shut down synth dataset engine")

    # ---- checkpoint state (reference recorder.py:177-226) ----
    def state_dict(self) -> Dict:
        return {
            "sample_weight_map": self.ccv.sample_weight_map.cpu().numpy(),
            "occurrence_map": self.ccv.occurrence_map.cpu().numpy(),
            "use_synth": self.use_synth,
            "epoch_idx": self.epoch_idx,
            "rng_state": self.generator.get_state().cpu().numpy(),
        }

    def load_state_dict(self, state: Dict):
        self.ccv = self.ccv._replace(
            sample_weight_map=torch.as_tensor(state["sample_weight_map"]).to(self.device),
            occurrence_map=torch.as_tensor(state["occurrence_map"]).to(self.device))
        if not state.get("use_synth", True):
            self.synth_shutdown()
        self.epoch_idx = int(state.get("epoch_idx", 0))
        if "rng_state" in state:
            self.generator.set_state(torch.as_tensor(state["rng_state"]))
