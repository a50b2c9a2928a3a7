"""Immutable per-instance view of the validator set.

Reference: upstream ``src/network_info.rs`` (``NetworkInfo``: ordered node
map, threshold ``PublicKeySet``, our ``SecretKeyShare``, ``num_faulty =
(N-1)/3``).  Fork checkout empty at survey time; see SURVEY.md §2 #2.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple


class NetworkInfo:
    """Validator-set view held (shared) by every protocol instance.

    Parameters
    ----------
    our_id:
        This node's id (may be an observer not in ``val_ids``).
    val_ids:
        The validator ids; stored sorted, and a validator's *index* (used
        for threshold-crypto share evaluation points) is its position in
        the sorted order.
    public_key_set:
        The threshold master public key (commitment to the secret poly).
    secret_key_share:
        Our share of the master secret; ``None`` for observers.
    public_keys:
        Per-node *regular* public keys (vote signing, DKG row encryption).
    secret_key:
        Our regular secret key.
    """

    def __init__(
        self,
        our_id: Any,
        val_ids: Sequence[Any],
        public_key_set: Any,
        secret_key_share: Optional[Any] = None,
        public_keys: Optional[Dict[Any, Any]] = None,
        secret_key: Optional[Any] = None,
    ) -> None:
        self._our_id = our_id
        self._val_ids: Tuple[Any, ...] = tuple(sorted(val_ids))
        self._index = {n: i for i, n in enumerate(self._val_ids)}
        self._public_key_set = public_key_set
        self._secret_key_share = secret_key_share
        self._public_keys = dict(public_keys or {})
        self._secret_key = secret_key

    # -- identities ---------------------------------------------------
    @property
    def our_id(self) -> Any:
        return self._our_id

    @property
    def all_ids(self) -> Tuple[Any, ...]:
        return self._val_ids

    def index(self, node_id: Any) -> int:
        return self._index[node_id]

    def contains(self, node_id: Any) -> bool:
        return node_id in self._index

    @property
    def our_index(self) -> Optional[int]:
        return self._index.get(self._our_id)

    def is_validator(self) -> bool:
        """Whether WE actively participate: listed in the validator set
        AND holding our threshold key share.  A node can be listed but
        share-less — e.g. it joined from a ``JoinPlan`` of an era whose
        DKG it did not observe; it then acts as an observer (commits
        batches, signs nothing) until a later era's DKG deals it a
        share.  Peers cannot distinguish this (``is_node_validator`` is
        membership-only), which is safe: the protocols never rely on a
        specific validator contributing, only on thresholds."""
        return self._our_id in self._index and self._secret_key_share is not None

    def is_node_validator(self, node_id: Any) -> bool:
        return node_id in self._index

    # -- sizes --------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self._val_ids)

    @property
    def num_faulty(self) -> int:
        """f = (N-1)//3, the maximum tolerated Byzantine nodes."""
        return (len(self._val_ids) - 1) // 3

    @property
    def num_correct(self) -> int:
        return self.num_nodes - self.num_faulty

    # -- keys ---------------------------------------------------------
    @property
    def public_key_set(self) -> Any:
        return self._public_key_set

    @property
    def secret_key_share(self) -> Optional[Any]:
        return self._secret_key_share

    @property
    def secret_key(self) -> Optional[Any]:
        return self._secret_key

    def public_key(self, node_id: Any) -> Any:
        return self._public_keys[node_id]

    @property
    def public_key_map(self) -> Dict[Any, Any]:
        return dict(self._public_keys)

    def public_key_share(self, node_id: Any) -> Any:
        """The threshold public-key share of ``node_id`` (by index)."""
        return self._public_key_set.public_key_share(self.index(node_id))

    def __repr__(self) -> str:
        return (
            f"NetworkInfo(our_id={self._our_id!r}, n={self.num_nodes}, "
            f"f={self.num_faulty}, validator={self.is_validator()})"
        )
