"""l(d) = log(1 + e^-d), l'(d) = -1 / (1 + e^d)."""

import torch


def terms(d):
    nd = d.neg_()
    # log(1 + e^x) without overflow for every x a pair can reach
    loss = torch.nn.functional.softplus(nd, threshold=50.0)
    return loss, torch.sigmoid(nd, out=nd).neg_()
