"""Config validation with friendly error messages.

(JAX counterpart: gmmvi_tpu/configs/validate.py)

Checks a config dict up front and reports every problem at once: missing
module-slot sections, unknown type names, missing required keys, likely
typos, and unknown ``tpu:`` keys.  The slot schema is derived from the
module defaults in :mod:`gmmvi_tpu_torch.configs`, so it cannot drift from
what the codename system produces.
"""
from __future__ import annotations

import difflib
import warnings
from typing import Iterable, List, Mapping, Optional

_KNOWN_TOP_LEVEL = {
    "temperature", "seed", "start_seed",
    "environment_name", "environment_config", "target_fn",
    "model_initialization", "gmmvi_runner_config",
    "use_sample_database", "max_database_size",
    "mmd_evaluation_config", "dump_gmm_path", "tpu",
}

_MODEL_INIT_KEYS = {
    "use_diagonal_covs", "num_initial_components", "prior_mean",
    "prior_scale", "initial_cov",
}

# the tpu.* keys of the JAX package, accepted with the same meanings
_KNOWN_TPU_KEYS = {
    "debug_nans", "max_background_dists", "max_dist_ring_iters",
    "dist_ring_iters", "reservoir_capacity", "db_eviction",
    "decimate_capacity_cap", "max_dists", "max_components",
    "max_reward_history_length", "trust_region_search",
    "trust_region_grid_size", "compact_target_eval",
    "data_shards", "comp_shards", "db_layout",
}


class ConfigError(ValueError):
    """Raised by :func:`validate_config` with a bulleted list of problems."""


def _load_slot_schema() -> dict:
    """slot -> {type_key, config_key, types: {type_name: {keys...}}}."""
    from gmmvi_tpu_torch.configs import ALL_CODENAME_LETTERS, LETTER_DEFAULTS

    schema = {}
    for slot, letters in sorted(ALL_CODENAME_LETTERS.items()):
        types = {}
        type_key = config_key = None
        for letter in letters:
            doc = LETTER_DEFAULTS[letter]
            type_key = next(k for k in doc if k.endswith("_type"))
            config_key = next(k for k in doc if k.endswith("_config"))
            types[str(doc[type_key])] = set((doc[config_key] or {}).keys())
        schema[slot] = {"type_key": type_key, "config_key": config_key,
                        "types": types}
    return schema


def _suggest(key: str, candidates: Iterable[str]) -> str:
    match = difflib.get_close_matches(key, list(candidates), n=1, cutoff=0.6)
    return f" — did you mean '{match[0]}'?" if match else ""


def _check_mapping(section: str, got: Mapping, known: Iterable[str],
                   problems: List[str], strict: bool) -> None:
    known = set(known)
    for key in got:
        if key not in known:
            msg = f"{section}: unknown key '{key}'{_suggest(key, known)}"
            if strict:
                problems.append(msg)
            else:
                warnings.warn(msg, stacklevel=4)


def validate_config(config: Mapping, require_target: bool = False,
                    strict: Optional[bool] = None) -> None:
    """Check a reference-schema config dict; raise :class:`ConfigError`
    listing all problems.  Unknown ``tpu:`` keys are errors unless
    ``strict=False``; unknown keys elsewhere warn unless ``strict=True``."""
    from gmmvi_tpu_torch.configs import ALL_CODENAME_LETTERS

    problems: List[str] = []
    if not isinstance(config, Mapping):
        raise ConfigError(f"config must be a mapping, got {type(config)}")
    schema = _load_slot_schema()

    all_slot_keys = {s["type_key"] for s in schema.values()} | {
        s["config_key"] for s in schema.values()}
    _check_mapping("config", config, _KNOWN_TOP_LEVEL | all_slot_keys,
                   problems, strict=bool(strict))

    for slot, letters in sorted(ALL_CODENAME_LETTERS.items()):
        spec = schema[slot]
        tkey, ckey = spec["type_key"], spec["config_key"]
        if tkey not in config:
            problems.append(
                f"missing '{tkey}' (module slot '{slot}'; provided by "
                f"codename letters {'/'.join(letters)} via "
                f"get_default_algorithm_config)")
            continue
        tname = str(config[tkey])
        if tname not in spec["types"]:
            problems.append(
                f"{tkey}: unknown type '{tname}'"
                f"{_suggest(tname, spec['types'])} "
                f"(supported: {sorted(spec['types'])})")
            continue
        required = spec["types"][tname]
        section = config.get(ckey)
        if section is None:
            if required:
                problems.append(
                    f"missing '{ckey}' (required keys for "
                    f"{tkey}='{tname}': {sorted(required)})")
            continue
        if not isinstance(section, Mapping):
            problems.append(f"'{ckey}' must be a mapping, got "
                            f"{type(section).__name__}")
            continue
        extra_ok = ({"initial_l2_regularizer"}
                    if ckey == "ng_estimator_config" else set())
        for key in required:
            if key not in section:
                problems.append(f"{ckey}: missing key '{key}' "
                                f"(required for {tkey}='{tname}')")
        slot_union = set().union(*spec["types"].values())
        _check_mapping(ckey, section, slot_union | extra_ok, problems,
                       strict=bool(strict))

    if "temperature" not in config:
        problems.append("missing 'temperature' (reference experiment "
                        "configs set it at top level, e.g. temperature: 1.)")
    if require_target and "target_fn" not in config \
            and "environment_name" not in config:
        problems.append("missing target: set 'environment_name' (+ "
                        "'environment_config') or pass 'target_fn'")
    if "environment_name" in config and "model_initialization" not in config:
        problems.append("missing 'model_initialization' (needs "
                        f"{sorted(_MODEL_INIT_KEYS - {'initial_cov'})})")
    mi = config.get("model_initialization")
    if isinstance(mi, Mapping):
        for key in ("num_initial_components", "prior_mean", "prior_scale",
                    "use_diagonal_covs"):
            if key not in mi:
                problems.append(f"model_initialization: missing key '{key}'")
        _check_mapping("model_initialization", mi, _MODEL_INIT_KEYS,
                       problems, strict=bool(strict))

    tpu_cfg = config.get("tpu")
    if isinstance(tpu_cfg, Mapping):
        _check_mapping("tpu", tpu_cfg, _KNOWN_TPU_KEYS, problems,
                       strict=True if strict is None else bool(strict))
        for key, allowed in (
            ("db_layout", ("auto", "global", "sharded")),
            ("db_eviction", ("ring", "decimate")),
            ("compact_target_eval", ("auto", "on", "off")),
            ("trust_region_search",
             ("bracket", "bracket-eigen", "grid", "newton")),
        ):
            val = tpu_cfg.get(key)
            if val is not None and str(val) not in allowed:
                problems.append(
                    f"tpu.{key}: unknown value {val!r} (expected one of "
                    f"{', '.join(allowed)})")

    mmd = config.get("mmd_evaluation_config")
    if isinstance(mmd, Mapping):
        for key in ("sample_dir", "alpha"):
            if key not in mmd:
                problems.append(
                    f"mmd_evaluation_config: missing key '{key}'")

    if "gmmvi_runner_config" in config:
        rc = config["gmmvi_runner_config"]
        if not isinstance(rc, Mapping) or "log_metrics_interval" not in rc:
            problems.append("gmmvi_runner_config: missing key "
                            "'log_metrics_interval'")

    if problems:
        raise ConfigError(
            "invalid GMMVI config ({} problem{}):\n  - {}".format(
                len(problems), "s" if len(problems) != 1 else "",
                "\n  - ".join(problems)))
