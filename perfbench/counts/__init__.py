"""The yardstick's counts of work: the operations and bytes each
configuration's fit and predict need, from the configuration's shapes
(never from launch shapes), and the card's peaks."""
