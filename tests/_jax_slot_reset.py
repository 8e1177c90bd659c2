"""The port's slot clearing, given to a JAX engine that a port test holds
the port's engine against.

The port's ``Engine._install`` resets a slot's cache rows to a fresh
cache's before a sequence occupies it (``Transformer.clear_slot``), so no
row of an earlier occupant, nor tiered memory's poison, reaches the new
occupant's decode store.  JAX's engine keeps those rows (``ROADMAP.md`` §3:
the reference's fault, repaired in the port only).  A test that compares
token streams across a reused slot wraps the JAX engine with
:func:`clear_slots_on_install`, so both engines start each occupant from
the same rows.
"""
import jax.numpy as jnp


def clear_slots_on_install(jeng):
    """Make ``jeng`` (a ``repro.serving.Engine`` no step has run on) reset a
    slot's rows in every per-position cache entry (``pos*``: arrays
    ``[n_cycles, batch, ...]``) to their values at construction before each
    install -> ``jeng``."""
    fresh = {key: {name: jnp.array(a[:, 0]) for name, a in entry.items()}
             for key, entry in jeng.cache.items() if key.startswith("pos")}
    install = jeng._install

    def _install(adm):
        cache = dict(jeng.cache)
        for key, rows in fresh.items():
            entry = dict(cache[key])
            for name, row in rows.items():
                entry[name] = entry[name].at[:, adm.slot].set(row)
            cache[key] = entry
        jeng.cache = cache
        install(adm)

    jeng._install = _install
    return jeng
