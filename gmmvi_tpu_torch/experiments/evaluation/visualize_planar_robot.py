"""Planar-robot figures (matplotlib, imported by the functions that draw).

(JAX counterpart: gmmvi_tpu/experiments/evaluation/visualize_planar_robot.py)

Arm configurations of mixture means, shaded by component weight, and of
samples.  Inputs are numpy arrays (or anything ``np.asarray`` takes).
"""
from __future__ import annotations

import numpy as np


def visualize_mixture(mixture_weights, mixture_means, link_lengths=None,
                      ax=None, goals=None):
    """Draw each component mean as an arm configuration; line alpha encodes
    the component weight."""
    import matplotlib.pyplot as plt

    mixture_weights = np.asarray(mixture_weights)
    mixture_means = np.asarray(mixture_means)
    num_dimensions = mixture_means.shape[1]
    if link_lengths is None:
        link_lengths = np.ones(num_dimensions)
    if ax is None:
        ax = plt.gca()
    ax.set_xlim([-num_dimensions, num_dimensions])
    ax.set_ylim([-num_dimensions, num_dimensions])

    wspan = mixture_weights.max() - mixture_weights.min()
    if wspan != 0:
        alphas = 0.1 + 0.9 * (mixture_weights - mixture_weights.min()) / wspan
    else:
        alphas = np.ones(len(mixture_weights))

    for theta, alpha in zip(mixture_means, alphas):
        angles = np.cumsum(theta)
        xs = np.concatenate([[0.0], np.cumsum(link_lengths * np.cos(angles))])
        ys = np.concatenate([[0.0], np.cumsum(link_lengths * np.sin(angles))])
        ax.plot(xs, ys, color="k", linestyle="-", linewidth=2, alpha=alpha)
        ax.plot(xs[-1], ys[-1], "o", color="red", alpha=alpha, markersize=6)

    if goals is not None:
        for g in np.asarray(goals):
            ax.plot(g[0], g[1], "rx", markersize=10, mew=2)
    return ax


def visualize_samples(samples, thinning=1, link_lengths=None, ax=None):
    """Draw sampled arm configurations
   ."""
    samples = np.asarray(samples)[::thinning]
    weights = np.ones(len(samples))
    return visualize_mixture(weights, samples, link_lengths=link_lengths,
                             ax=ax)


def _goal_positions(num_goals, num_links):
    """Goals evenly spaced on a circle of radius 0.7*num_links
   ."""
    angles = 2 * np.pi * np.arange(num_goals) / num_goals
    return 0.7 * num_links * np.stack(
        [np.cos(angles), np.sin(angles)], axis=-1)


def visualize_n_link_multi(theta, length, num_goals, num_arms, num_links,
                           ax=None):
    """Draw one sample holding ``num_arms`` concatenated arm configurations,
    with the circular goal layout."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    length = np.asarray(length)
    theta = np.reshape(np.asarray(theta), (num_arms, num_links))
    ax.set_xlim([-num_links, num_links])
    ax.set_ylim([-num_links, num_links])

    angles = np.cumsum(theta, axis=1)                     # [arms, links]
    xs = np.concatenate(
        [np.zeros((num_arms, 1)),
         np.cumsum(length[None, :] * np.cos(angles), axis=1)], axis=1)
    ys = np.concatenate(
        [np.zeros((num_arms, 1)),
         np.cumsum(length[None, :] * np.sin(angles), axis=1)], axis=1)
    for a in range(num_arms):
        ax.plot(xs[a], ys[a], color="k", linestyle="-", linewidth=2)
        ax.plot(xs[a, -1], ys[a, -1], "o")
    for gx, gy in _goal_positions(num_goals, num_links):
        ax.plot(gx, gy, "rx")
    return ax


def visualize_samples_multi(samples, num_goals, num_arms, num_links,
                            thinning=1, ax=None):
    """Overlay thinned samples of multi-arm configurations
   ."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    samples = np.asarray(samples)[::thinning]
    for theta in samples:
        visualize_n_link_multi(theta, np.ones(num_links), num_goals,
                               num_arms, num_links, ax=ax)
    return ax


def visualize_samples_multi_grid(samples, num_goals, num_arms, num_links,
                                 thinning=1, grid=(10, 10)):
    """One subplot per sample on a grid, each showing the multi-arm
    configuration and the goal circle
   .  Returns the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples = np.asarray(samples)[::thinning]
    fig, axs = plt.subplots(*grid, figsize=(2 * grid[1], 2 * grid[0]))
    for theta, ax in zip(samples, np.asarray(axs).flatten()):
        visualize_n_link_multi(theta, np.ones(num_links), num_goals,
                               num_arms, num_links, ax=ax)
        ax.set_xticks([])
        ax.set_yticks([])
    return fig
