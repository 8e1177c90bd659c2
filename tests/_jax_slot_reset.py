"""The port's slot clearing, and its slot length after a prefill with
prefix embeddings, given to a JAX engine that a port test holds the port's
engine against.

The port's ``Engine._install`` resets a slot's cache rows to a fresh
cache's before a sequence occupies it (``Transformer.clear_slot``), so no
row of an earlier occupant, nor tiered memory's poison, reaches the new
occupant's decode store.  JAX's engine keeps those rows (``ROADMAP.md`` §3:
the reference's fault, repaired in the port only).  A test that compares
token streams across a reused slot wraps the JAX engine with
:func:`clear_slots_on_install`, so both engines start each occupant from
the same rows.

After a single-shot prefill of ``P`` prefix embeddings and ``S`` prompt
tokens a ``"vlm"`` / ``"audio"`` model's JAX engine sets the slot's length
to ``S`` (its model's own cache says ``P + S``), so its decode overwrites
the prompt's last rows and attends none past them (``ROADMAP.md`` §3,
repaired in the port only); :func:`count_prefix_rows` gives a JAX engine
the port's ``P + S``.  A model of another family embeds the tokens alone,
and both engines set ``S``.
"""
import jax.numpy as jnp


def clear_slots_on_install(jeng):
    """Make ``jeng`` (a ``repro.serving.Engine`` no step has run on) reset a
    slot's rows in every per-position cache entry (``pos*``: arrays
    ``[n_cycles, batch, ...]``; a remainder layer's ``rest[j]``: arrays
    ``[batch, ...]``) to their values at construction before each install
    -> ``jeng``."""
    fresh = {key: {name: jnp.array(a[:, 0]) for name, a in entry.items()}
             for key, entry in jeng.cache.items() if key.startswith("pos")}
    fresh_rest = [{name: jnp.array(a[0]) for name, a in entry.items()}
                  for entry in jeng.cache.get("rest", [])]
    install = jeng._install

    def _install(adm):
        cache = dict(jeng.cache)
        for key, rows in fresh.items():
            entry = dict(cache[key])
            for name, row in rows.items():
                entry[name] = entry[name].at[:, adm.slot].set(row)
            cache[key] = entry
        if fresh_rest:
            cache["rest"] = [
                {name: a.at[adm.slot].set(fresh_rest[j][name])
                 for name, a in entry.items()}
                for j, entry in enumerate(cache["rest"])]
        jeng.cache = cache
        install(adm)

    jeng._install = _install
    return jeng


def count_prefix_rows(jeng):
    """Make ``jeng`` set a prefix-embedding request's slot length to its
    embeddings' rows plus its prompt's as its prefill completes, where its
    model embeds them (a ``"vlm"`` / ``"audio"`` one) -> ``jeng``."""
    finish = jeng._finish_prefill
    embeds = jeng.cfg.family in ("vlm", "audio")

    def _finish_prefill(seq, logits):
        if embeds and seq.req.prefix_emb is not None:
            jeng._seq_len[seq.slot] = len(seq.req.prefix_emb) + seq.n_prefill
        finish(seq, logits)

    jeng._finish_prefill = _finish_prefill
    return jeng
